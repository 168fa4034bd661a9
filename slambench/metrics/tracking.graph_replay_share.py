"""tracking.graph_replay_share: the program's track_graph_replays counter (the
tracking iterations whose gradient graphs were replayed) over the window, per
tracking iteration (n_track.iter), in percent. A program without the counter
reports nothing."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("n_track.iter")
    if not n or "track_graph_replays" not in t:
        return None
    return 100.0 * t["track_graph_replays"] / n

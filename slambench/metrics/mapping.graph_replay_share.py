"""mapping.graph_replay_share: the program's map_graph_replays counter (the
mapping iterations that replayed their CUDA graphs) over the window, per
mapping iteration (n_map.iter), in percent. A program without the counter
reports nothing."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("n_map.iter")
    if not n or "map_graph_replays" not in t:
        return None
    return 100.0 * t["map_graph_replays"] / n

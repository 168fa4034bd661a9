"""frontend.stereo_ms_per_frame: the program's stereo stage (spans
fe.stereo_depth, the gray conversion and SGBM; fe.stereo_orb, both ORB
extractions; fe.stereo_match, ComputeStereoMatches) over the window, per
window frame. A program without the spans reports nothing."""

SPANS = ("fe.stereo_depth", "fe.stereo_orb", "fe.stereo_match")


def read(ctx):
    w = ctx["window"]
    t = w["timings"]
    if not w["frames"] or any(s not in t for s in SPANS):
        return None
    return 1000.0 * sum(t[s] for s in SPANS) / w["frames"]

"""frontend.stereo_match_share: the program's stereo_matches counter (left
keypoints given a depth after ComputeStereoMatches' median filter) over its
stereo_keypoints counter (valid left keypoints), in the window, in percent.
A program without the counters reports nothing."""


def read(ctx):
    t = ctx["window"]["timings"]
    n = t.get("stereo_keypoints")
    if not n or "stereo_matches" not in t:
        return None
    return 100.0 * t["stereo_matches"] / n

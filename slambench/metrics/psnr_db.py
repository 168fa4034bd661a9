"""psnr_db: mean PSNR over the eval_frames prefix of the reference's render
of the map (snapshot after the prefix) at the tracked poses, on the pixels
with a depth reading."""


def read(ctx):
    return ctx["psnr_db"]

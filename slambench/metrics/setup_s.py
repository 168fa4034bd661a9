"""setup_s: process start to the window's start (imports, the kernel
library, the frames, the System, frame 0's initialisation, warm-up)."""


def read(ctx):
    return ctx["setup_s"]

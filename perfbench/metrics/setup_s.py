"""setup_s: process start to the window's start (loading, inputs, warm-up,
graph capture, and in a checkout's first run the kernels' build)."""


def read(rec):
    return rec.setup_s

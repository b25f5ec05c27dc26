"""setup_s: process start to the first timed request (CUDA init, kernel
load, tile generation and encode, tiling, upload, warm-up), host clock."""


def read(ctx):
    return ctx.setup_s

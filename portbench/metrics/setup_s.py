"""Set-up: from the start of the process to the start of the window (host
clock): imports, the models made from the seed, the experts cut, every CUDA
graph captured and the kernels built or loaded, the warm-up request."""


def read(ctx):
    return ctx.setup_s

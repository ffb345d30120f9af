"""Process start to the window: imports, CUDA start, the kernels, the
molecules, the program's data path, the model and weights, the checked
steps and the warm-up epoch."""


def read(ctx):
    return ctx["setup_s"]

"""setup_s: seconds from the process's start to the first timed call (imports, the CUDA
context, kernel builds or loads, assets, Scene.compile, the warm call at the cell's shape)."""


def read(run):
    return run.setup_s

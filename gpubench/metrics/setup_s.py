"""From the start of the process to the opening of the window: imports,
CUDA start, data, index fit and build, kernel builds and warm-up."""


def read(run):
    return run.setup_s

"""Set-up seconds: from the start of the run's module, before any import
of PyTorch or the program, to the window's first request.  Imports, CUDA
start, the kernels' load (and build, in a checkout's first run), the
inputs and the warm-up.  The seconds in which the plain reference made
inputs in set-up (``state.reference_s``: the read cell's archives) are
the benchmark's own and are left out."""


def read(ctx):
    return ctx.setup_s - getattr(ctx.state, "reference_s", 0.0)

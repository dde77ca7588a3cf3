"""Set-up: from process start to the window's first call (imports, the
CUDA context, loading the built library, state and weights from the seed,
the warm-up of the cell's own shapes)."""


def read(rec, name):
    return rec.setup_s

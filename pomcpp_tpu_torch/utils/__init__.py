from .checkpoint import restore_checkpoint, save_checkpoint  # noqa: F401

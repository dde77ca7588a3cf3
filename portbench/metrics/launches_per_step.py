"""Kernels, memory copies and memory sets the profiler records per call
(per env step in the env loop) of the traced window."""


def read(rec, name):
    if not rec.ops or not rec.calls:
        return None
    return len(rec.ops) / rec.calls

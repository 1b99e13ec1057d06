"""Megabytes a fold that rank 0 handed to the program's all-gathers (its
``collective_counts()["all_gather"]["bytes"]``)."""
from _sheet import per_fold


def read(run):
    vals = per_fold(run, ("all_gather_bytes",), 1e-6, ranks=run.ranks[:1])
    return vals[0] if vals and vals[0] > 0 else None

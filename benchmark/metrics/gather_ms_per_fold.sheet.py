"""Milliseconds a fold of the all-gather of every rank's voxel statistics
(the program's ``gather`` span), the ranks' mean (``run.ranks``)."""
from _sheet import per_fold


def read(run):
    vals = per_fold(run, ("span_gather_s",), 1e3)
    return sum(vals) / len(vals) if vals else None

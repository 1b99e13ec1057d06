"""Milliseconds a fold of the exact merge of the gathered statistics (the
program's ``merge`` span), the ranks' mean (``run.ranks``)."""
from _sheet import per_fold


def read(run):
    vals = per_fold(run, ("span_merge_s",), 1e3)
    return sum(vals) / len(vals) if vals else None

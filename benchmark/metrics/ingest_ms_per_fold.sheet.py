"""Milliseconds a fold of a rank's host read and upload (the program's
``read`` and ``upload`` spans), the slowest rank's (``run.ranks``)."""
from _sheet import per_fold


def read(run):
    vals = per_fold(run, ("span_read_s", "span_upload_s"), 1e3)
    return max(vals) if vals else None

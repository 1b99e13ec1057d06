"""Scans registered in the window over its seconds."""
from _shared import rate


def read(run):
    return rate(run, "scans")

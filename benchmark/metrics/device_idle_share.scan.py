"""Percent of the traced window in which the card ran no kernel, copy or
set (1 minus the union of their intervals over the window)."""
from _shared import idle_share


def read(run):
    return idle_share(run, "scans")

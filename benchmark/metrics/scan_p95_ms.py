"""The 95th percentile (nearest rank) of the host-clock time of every
``add_scan`` of the window, each ending in a synchronise."""
from _shared import percentile


def read(run):
    if not run.units or "scans" not in run.units[0]:
        return None
    return percentile([u["seconds"] * 1e3 for u in run.units], 95)

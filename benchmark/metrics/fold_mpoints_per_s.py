"""Points of every whole-file fold completed in the window, in millions,
over the window's seconds (read, upload, voxelize and merge included)."""
from _shared import rate


def read(run):
    return rate(run, "points", 1e-6) if run.units and \
        "folds" in run.units[0] else None

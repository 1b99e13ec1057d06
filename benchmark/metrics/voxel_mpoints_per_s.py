"""Valid points voxelized by every tiled step completed in the window, in
millions, over the window's seconds."""
from _shared import rate


def read(run):
    return rate(run, "points", 1e-6) if run.units and \
        "steps" in run.units[0] else None

"""Device kernels in the trace over the tiled steps."""
from _shared import launches


def read(run):
    return launches(run, "steps")

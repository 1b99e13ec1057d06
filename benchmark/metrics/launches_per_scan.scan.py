"""Device kernels in the trace over the scans registered."""
from _shared import launches


def read(run):
    return launches(run, "scans")

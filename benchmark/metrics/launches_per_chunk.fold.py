"""Device kernels in the trace over the chunks folded."""
from _shared import launches


def read(run):
    return launches(run, "chunks")

"""The probe's units over the window's seconds."""
from _shared import rate


def read(run):
    return rate(run, "units")

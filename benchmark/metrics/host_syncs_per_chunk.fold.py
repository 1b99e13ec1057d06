"""The fold's host reads of device values (its ``HOST_SYNCS`` counter)
over the chunks it folded."""
from _shared import per


def read(run):
    if "host_syncs" not in run.counters:
        return None
    return per(run, run.counters["host_syncs"], "chunks")

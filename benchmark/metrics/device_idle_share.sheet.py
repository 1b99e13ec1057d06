"""Percent of the traced window in which a rank's card ran no kernel, copy
or set, the ranks' mean (``run.ranks``)."""


def read(run):
    ranks = [r for r in run.ranks if r["device_busy_s"] is not None
             and r["trace_window_s"] and r["units"]
             and "folds" in r["units"][0]]
    if not ranks:
        return None
    return sum(100.0 * (1.0 - r["device_busy_s"] / r["trace_window_s"])
               for r in ranks) / len(ranks)

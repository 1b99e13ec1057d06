"""Arithmetic of the sheet fold's readers: a rank's program counters over
the window, per fold."""


def per_fold(run, keys, scale, ranks=None):
    """For each rank (``run.ranks``, or ``ranks``) the sum of its counters
    ``keys`` over the folds it ran, times ``scale``; ``[]`` where a rank
    lacks one of them or ran no fold."""
    out = []
    for r in run.ranks if ranks is None else ranks:
        folds = sum(u.get("folds", 0) for u in r["units"])
        if not folds or any(k not in r["counters"] for k in keys):
            return []
        out.append(scale * sum(r["counters"][k] for k in keys) / folds)
    return out

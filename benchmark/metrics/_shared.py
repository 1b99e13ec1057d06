"""Arithmetic the metric readers share.  Each reader returns ``None`` where
its run holds nothing for it to read (another cell's units, or no trace)."""

from __future__ import annotations

import math


def rate(run, key: str, scale: float = 1.0):
    """Units' ``key`` summed over the window's seconds, times ``scale``."""
    if not run.units or key not in run.units[0] or run.window_s <= 0:
        return None
    return run.total(key) / run.window_s * scale


def per(run, numerator: float, key: str):
    if run.device_busy_s is None or not run.units or key not in run.units[0]:
        return None
    return numerator / run.total(key)


def launches(run, key: str):
    """Device kernels in the trace over the units' ``key``."""
    return per(run, float(len(run.kernels)), key)


def idle_share(run, key: str):
    """Percent of the traced window in which no kernel, copy or set ran."""
    if run.device_busy_s is None or not run.units or key not in run.units[0]:
        return None
    return 100.0 * (1.0 - run.device_busy_s / run.trace_window_s)


def percentile(values, q: float):
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it."""
    v = sorted(values)
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]

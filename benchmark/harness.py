"""The benchmark's machinery, the same for every cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix.  Each is a data file found by its name:
``configs/<config>.json`` and ``workloads/<traffic>.json``.  The traffic
file names the driver (``drivers/<driver>.py``) that sets the cell up, runs
one unit of its work and checks what the program produced.  Each metric is
a reader of its own, ``metrics/<metric name>.py``, with a function
``read(run)`` that returns the number, or ``None`` where the run holds
nothing for it to read.  Nothing here needs an edit when a cell, a
configuration or a metric is added as files.

One run: the driver's set-up (data made from the seed, every shape warmed
up), then a window of ``seconds`` in which units run back to back (a
closed loop: the next unit starts when the last one has returned), then
the check.  With ``trace`` the window is a stretch of ``trace_units``
units under ``torch.profiler`` instead, and the per-layer metrics are
read from its trace.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import random
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "metrics"))

#: top-level modules that may not be loaded in a run: JAX and the package
#: the program was ported from (compared by whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "pasture_tpu")

#: device activity in a Chrome trace of ``torch.profiler``
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver", "python_function")


def load_json(kind: str, name: str) -> Dict:
    path = ROOT / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def process_age() -> float:
    """Seconds since this process started, from ``/proc``."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream of unknown
    length, drawn from ``seed`` (Algorithm R)."""

    def __init__(self, k: int, seed: int) -> None:
        self.k, self.rng, self.seen = k, random.Random(seed), 0
        self.items: List = []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Run:
    """What a metric reader may read about one run."""

    def __init__(self) -> None:
        self.cell: Dict = {}
        self.setup_s = 0.0
        self.window_s = 0.0
        self.units: List[Dict] = []        # one record a unit
        self.counters: Dict[str, float] = {}   # program counters, window
        self.info: Dict = {}               # the driver's own facts
        self.kernels: List = []            # traced: (name, start_us, dur_us)
        self.device_busy_s: Optional[float] = None
        self.host: Dict = {}               # the window's host-side facts
        self.trace_window_s = 0.0

    def total(self, key: str) -> float:
        return float(sum(u.get(key, 0) for u in self.units))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _cpu_steal() -> float:
    """Seconds the hypervisor gave this machine's CPUs to others (the
    ``steal`` column of ``/proc/stat``), 0 where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


def run_units(driver, run: Run, seconds: Optional[float],
              count: Optional[int], device) -> None:
    """Units back to back: until ``seconds`` have passed (the unit running
    then completes and counts), or ``count`` units."""
    before = driver.counters()
    cpu0, steal0 = os.times(), _cpu_steal()
    t0 = time.perf_counter()
    deadline = t0 + seconds if seconds is not None else None
    i = 0
    while True:
        a = time.perf_counter()
        with torch.profiler.record_function("bench.unit"):
            rec = driver.unit(i)
        _sync(device)
        b = time.perf_counter()
        rec["seconds"] = b - a
        run.units.append(rec)
        i += 1
        if deadline is not None and b >= deadline:
            break
        if count is not None and i >= count:
            break
    run.window_s = time.perf_counter() - t0
    cpu1, steal1 = os.times(), _cpu_steal()
    secs = sorted(u["seconds"] for u in run.units)
    run.host = {"units": len(secs), "unit_s_min": secs[0],
                "unit_s_median": secs[len(secs) // 2],
                "unit_s_max": secs[-1],
                "process_cpu_s": (cpu1.user + cpu1.system)
                - (cpu0.user + cpu0.system),
                "machine_steal_s": steal1 - steal0}
    after = driver.counters()
    run.counters = {k: after[k] - before.get(k, 0) for k in after}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(path: str, run: Run) -> Dict:
    """Device activity of the traced window: busy seconds (the union of
    kernel, copy and set intervals), the kernels, and the breakdown: the
    ten device operations that took most time and the ten host activities
    under which the device stood idle longest."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("name") == "bench.window"
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    tid = (window[0].get("pid"), window[0].get("tid"))
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        s = float(e["ts"])
        d = float(e["dur"])
        if cat in DEVICE_CATEGORIES:
            s, t = max(s, w0), min(s + d, w1)
            if t > s:
                dev.append((e.get("name", "?"), s, t - s, cat))
        elif cat in HOST_CATEGORIES and (e.get("pid"), e.get("tid")) == tid:
            host.append((s, s + d, e.get("name", "?")))
    busy = _merge([(s, s + d) for _, s, d, _ in dev])
    busy_us = sum(e - s for s, e in busy)
    run.kernels = [(n, s, d) for n, s, d, c in dev if c == "kernel"]
    run.device_busy_s = busy_us / 1e6
    run.trace_window_s = (w1 - w0) / 1e6
    by_op: Dict[str, float] = {}
    for n, _, d, _ in dev:
        by_op[n] = by_op.get(n, 0.0) + d / 1e6
    # every idle gap inside the window, put down to the innermost activity
    # of the window's host thread that spans its middle: the host events
    # of one thread nest, so a sweep with a stack finds it
    gaps, at = [], w0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    host.sort(key=lambda h: (h[0], -h[1]))
    by_host: Dict[str, float] = {}
    stack, k = [], 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while k < len(host) and host[k][0] <= mid:
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        inner = [h for h in stack[-8:] if h[1] >= mid]
        name = inner[-1][2] if inner else "(no host activity traced)"
        if name == "bench.unit":
            name = "host Python between operations"
        by_host[name] = by_host.get(name, 0.0) + (e - s) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e6,
            "breakdown": {"device_ops": [[n[:120], v] for n, v in top],
                          "idle_gaps": [[n[:120], v] for n, v in idle]}}


def traced_units(driver, run: Run, count: int, device, workdir: str
                 ) -> Dict:
    """``count`` units under the profiler; returns :func:`read_trace`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            run_units(driver, run, None, count, device)
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return read_trace(path, run)
    finally:
        os.remove(path)


def device_facts(device) -> Dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def metric_value(name: str, run: Run) -> Optional[float]:
    return load_module("metrics", name).read(run)


def run_cell(bench: Dict, cell: Dict, seed: int, seconds: float,
             trace: bool, device, control: bool = False) -> Dict:
    """One run of ``cell``; returns the result object (see run.py).
    Raises :class:`ForbiddenImport` where JAX or the package the program
    was ported from is loaded once the check has run."""
    config = load_json("configs", cell["config"])
    traffic = load_json("workloads", cell["traffic"])
    drv_mod = load_module("drivers", traffic["driver"])
    run = Run()
    run.cell = cell
    with tempfile.TemporaryDirectory(prefix="bench-") as workdir:
        driver = drv_mod.Driver(config, traffic, seed, device, workdir)
        try:
            if control:
                # the reference in a lower precision put in the program's
                # place: no window, only the comparison
                checks, failed = driver.check(control=True)
                info = {}
            else:
                if torch.device(device).type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                run.setup_s = process_age()
                if trace:
                    info = traced_units(driver, run, traffic["trace_units"],
                                        device, workdir)
                else:
                    run_units(driver, run, seconds, None, device)
                    info = {}
                facts = device_facts(device)
                run.info = driver.info()
                metrics = _metrics(bench, cell, run, trace)
                driver.release()
                gc.collect()
                if torch.device(device).type == "cuda":
                    torch.cuda.empty_cache()
                checks, failed = driver.check(control=False)
        finally:
            driver.close()
    # after the window, the program's release and the check: whatever
    # loaded a forbidden module anywhere in the run is caught here
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct),
           "attempted": len(run.units), "failed": int(failed)}
    if not control:
        out["metrics"] = metrics
        facts = dict(facts)
        if trace:
            facts["busy_s"] = run.device_busy_s
            facts["window_s"] = info["window_s"]
        out["device"] = facts
        if trace:
            out["breakdown"] = info["breakdown"]
        out["window"] = dict(run.host, seconds=run.window_s,
                             **run.info)
    out["checks"] = checks
    return out


class ForbiddenImport(RuntimeError):
    pass


def _metrics(bench: Dict, cell: Dict, run: Run, trace: bool) -> Dict:
    name = cell["name"]
    out = {}
    if not trace:
        for m in bench["end_to_end"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            v = run.setup_s if m["name"] == "setup_s" \
                else metric_value(m["name"], run)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    for m in bench["per_layer"]:
        listed = m.get("workloads")
        if listed is not None and name not in listed:
            continue
        if listed is None and m["moves"] not in e2e:
            continue
        v = metric_value(m["name"], run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out

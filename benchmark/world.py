"""A cell on several cards: one rank a card, all in one ``torch.distributed``
world.

:func:`run_ranks` starts ``n`` processes with the ``spawn`` start method.
Rank ``r`` takes card ``r`` (``torch.cuda.set_device(r)``, device
``"cuda:r"``; on the CPU, for the tests, ``"cpu"``) and joins the default
group (NCCL on the cards, gloo on the CPU), with an explicit timeout,
through a TCP store on localhost that the launching process serves.  The
harness makes a gloo group of the same ranks for its own bookkeeping (the
barrier that opens the window, the stop flag, the gathers), so it puts
nothing on the cards' streams.  Nothing of the
program starts or joins the world: the driver is built as on one card,
``Driver(config, traffic, seed, "cuda:r", workdir)``, once the world is up,
and learns its rank and the world's size from ``torch.distributed``.

The window runs in lockstep.  Each rank does its set-up and synchronises
its card; all meet at a barrier, and the window opens.  After each unit
every rank synchronises its card, rank 0 decides whether to stop (its
deadline has passed, or the traced count is reached) and sends the flag
to all, so every rank runs the same units.  A unit's ``seconds`` is the
slowest rank's, gathered once at the end; ``window_s`` is rank 0's clock
from the barrier to the last unit's end; ``setup_s`` is the launching
process's age when the window opens, so the spawn and every rank's
imports count.  In a traced run each rank profiles its own window (opened
together once every rank's profiler is on) and reads its own trace; the
result's ``busy_s`` and ``window_s`` are the ranks' means.

Rank 0's ``Run`` is what the metric readers read: its fields are rank 0's,
but for each unit's ``seconds``, and ``run.ranks`` holds one record a rank
(``rank``, ``card``, ``units``, ``counters``, ``kernels``,
``device_busy_s``, ``trace_window_s``).  The check runs on every rank
together and may use collectives; rank 0's ``checks`` and ``failed`` make
the result.  The result's ``device`` counts the distinct cards on which a
rank allocated memory, their common name, and the fullest card's peak;
``window.ranks`` holds each rank's card and facts.

A rank that raises, dies, or outlives the limit ends the run: every rank
is killed, its traceback (or the stacks of a rank still running) goes to
standard error, and :class:`RankFailed` is raised.  A rank that loaded JAX
or the package the program was ported from raises
:class:`harness.ForbiddenImport`, as one card does.
"""

from __future__ import annotations

import ctypes
import faulthandler
import gc
import multiprocessing as mp
import os
import queue as queue_mod
import signal
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

import harness

#: seconds a rank's set-up may take (a checkout's first run compiles)
SETUP_LIMIT_S = 840.0
#: seconds the check may take after the window
CHECK_LIMIT_S = 240.0
#: seconds any collective of either group may wait before it raises
TIMEOUT_S = 300.0
#: seconds a rank has to exit once it has handed in its result
EXIT_S = 60.0


class RankFailed(RuntimeError):
    """A rank raised, died, or ran past the run's limit."""


def run_ranks(bench: Dict, cell: Dict, seed: int, seconds: float,
              trace: bool, n: int, device: str = "cuda",
              control: bool = False, timeout_s: float = TIMEOUT_S,
              limit_s: Optional[float] = None) -> Dict:
    """One run of ``cell`` on ``n`` ranks, one a card (``device="cuda"``)
    or ``n`` CPU processes (``device="cpu"``); returns the result object
    (see run.py).  ``timeout_s`` bounds each collective; ``limit_s`` (by
    default set-up, window and check limits added) the whole run."""
    if limit_s is None:
        limit_s = SETUP_LIMIT_S + seconds + CHECK_LIMIT_S
    # the world's store, served from here on a port bound at once: a port
    # picked free and bound later by rank 0 can be taken in between, even
    # by another rank's own attempts to connect to it
    store = dist.TCPStore("localhost", 0, None, True,
                          timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    job = {"bench": bench, "cell": cell, "seed": seed, "seconds": seconds,
           "trace": trace, "control": control, "device": device, "size": n,
           "root": str(harness.ROOT), "port": store.port,
           "timeout_s": timeout_s, "parent": os.getpid(),
           # the launching process's start on the monotonic clock, which
           # every process of the machine shares
           "launched": time.monotonic() - harness.process_age()}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, job, results),
                         name=f"bench-rank-{r}") for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit_s
    done: Dict[int, tuple] = {}
    try:
        while len(done) < n:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                if _dead(procs, done) or time.monotonic() > deadline:
                    _fail(procs, done, results, [], deadline, limit_s)
                continue
            if not ok:
                _fail(procs, done, results, [(rank, value)], deadline,
                      limit_s)
            done[rank] = value
        for p in procs:
            p.join(timeout=EXIT_S)
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RankFailed(f"ranks exited with codes {bad} "
                             f"(None: still running after {EXIT_S:g} s)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        del store
    bad = [f"rank {r}: {', '.join(done[r][1])}" for r in sorted(done)
           if done[r][1]]
    own = harness.forbidden_modules()
    if own:
        bad.append(f"the launching process: {', '.join(own)}")
    if bad:
        raise harness.ForbiddenImport("; ".join(bad))
    return done[0][0]


def _dead(procs, done) -> List[int]:
    """Ranks that ended without handing in a result."""
    return [r for r, p in enumerate(procs)
            if p.exitcode is not None and r not in done]


def _fail(procs, done, results, raised, deadline, limit_s) -> None:
    """Raise :class:`RankFailed` for a world that failed: a rank raised
    (``raised``: ``[(rank, traceback)]``), died, or the run passed its
    limit.  The other ranks get two seconds to hand in what they raised in
    turn; a rank that died without a result is named first, as the likely
    cause; ranks still running dump their stacks.  Returns where all is
    well after all: a rank that ended had handed in its result."""
    grace = time.monotonic() + 2.0
    while time.monotonic() < grace:
        try:
            rank, ok, value = results.get(timeout=0.1)
        except queue_mod.Empty:
            continue
        if ok:
            done[rank] = value
        else:
            raised.append((rank, value))
    n = len(procs)
    gone = {r for r, _ in raised}
    lines = []
    dead = [r for r in _dead(procs, done) if r not in gone]
    if dead:
        lines.append(f"ranks {dead} of {n} exited with codes "
                     f"{[procs[r].exitcode for r in dead]} and no result")
    lines += [f"rank {r} of {n} failed:\n{tb}" for r, tb in raised]
    if not lines and time.monotonic() <= deadline:
        return
    if not lines:
        running = [r for r, p in enumerate(procs) if p.is_alive()]
        for r in running:
            os.kill(procs[r].pid, signal.SIGUSR1)
        time.sleep(2.0)
        lines.append(f"ranks {running} of {n} still running after the "
                     f"run's limit of {limit_s:g} s (their stacks are "
                     f"above)")
    raise RankFailed("\n".join(lines))


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when the launching one ends."""
    PR_SET_PDEATHSIG = 1
    ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(1)


def _rank_main(rank: int, job: Dict, results) -> None:
    """One rank: join the world, run the cell, hand in ``(rank, True,
    (result or None, forbidden modules))`` or ``(rank, False,
    traceback)``."""
    _die_with_parent(job["parent"])
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    try:
        harness.ROOT = Path(job["root"])
        torch.set_num_threads(1)
        if job["device"] == "cuda":
            torch.cuda.set_device(rank)
            device, backend = f"cuda:{rank}", "nccl"
        else:
            device, backend = "cpu", "gloo"
        timeout = timedelta(seconds=job["timeout_s"])
        store = dist.TCPStore("localhost", job["port"], job["size"], False,
                              timeout)
        dist.init_process_group(backend, store=store, world_size=job["size"],
                                rank=rank, timeout=timeout)
        book = dist.new_group(backend="gloo", timeout=timeout)
        value = _run(rank, job, device, book)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        # hand the traceback over before this rank ends; the launching
        # process kills the others
        results.close()
        results.join_thread()
        sys.stderr.flush()
        os._exit(1)
    results.put((rank, True, value))
    results.close()
    results.join_thread()
    dist.destroy_process_group()


def _run(rank: int, job: Dict, device: str, book):
    """:func:`harness.run_cell` on one rank of the world: returns ``(the
    result or None off rank 0, forbidden modules loaded here)``."""
    bench, cell, trace = job["bench"], job["cell"], job["trace"]
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("workloads", cell["traffic"])
    drv_mod = harness.load_module("drivers", traffic["driver"])
    cuda = torch.device(device).type == "cuda"
    run = harness.Run()
    run.cell = cell
    with tempfile.TemporaryDirectory(prefix=f"bench-rank{rank}-") as workdir:
        driver = drv_mod.Driver(config, traffic, job["seed"], device, workdir)
        try:
            if job["control"]:
                checks, failed = driver.check(control=True)
            else:
                if cuda:
                    torch.cuda.reset_peak_memory_stats(device)
                harness._sync(device)
                dist.monitored_barrier(
                    group=book, wait_all_ranks=True,
                    timeout=timedelta(seconds=job["timeout_s"]))
                setup_s = time.monotonic() - job["launched"]
                if trace:
                    info = _traced_units(driver, run, traffic["trace_units"],
                                         device, workdir, book, rank)
                else:
                    _lockstep_units(driver, run, job["seconds"], None,
                                    device, book, rank)
                    info = {}
                mine = _rank_record(rank, device, run, trace)
                run.info = driver.info()
                ranks: List[Dict] = [None] * job["size"] if rank == 0 \
                    else None
                dist.gather_object(mine, ranks, dst=0, group=book)
                if rank == 0:
                    facts = _merge_ranks(run, ranks, setup_s, cuda)
                    metrics = harness._metrics(bench, cell, run, trace)
                driver.release()
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
                checks, failed = driver.check(control=False)
        finally:
            driver.close()
    # after the window, the program's release and the check
    forbidden = harness.forbidden_modules()
    if rank != 0:
        return None, forbidden
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct),
           "attempted": len(run.units), "failed": int(failed)}
    if not job["control"]:
        out["metrics"] = metrics
        if trace:
            # both over the ranks, each rank's busy time inside its window
            n = len(run.ranks)
            facts["busy_s"] = sum(r["device_busy_s"] for r in run.ranks) / n
            facts["window_s"] = sum(r["trace_window_s"] for r in run.ranks) / n
        out["device"] = facts
        if trace:
            out["breakdown"] = info["breakdown"]
        out["window"] = dict(run.host, seconds=run.window_s, **run.info,
                             ranks=[_rank_summary(r, trace)
                                    for r in run.ranks])
    out["checks"] = checks
    return out, forbidden


def _lockstep_units(driver, run, seconds: Optional[float],
                    count: Optional[int], device, book, rank: int) -> None:
    """:func:`harness.run_units` in step with the other ranks: after each
    unit rank 0 sends whether to stop, so every rank runs the same units."""
    before = driver.counters()
    cpu0, steal0 = os.times(), harness._cpu_steal()
    stop = torch.zeros(1, dtype=torch.int32)
    t0 = time.perf_counter()
    deadline = t0 + seconds if seconds is not None else None
    i = 0
    while True:
        a = time.perf_counter()
        with torch.profiler.record_function("bench.unit"):
            rec = driver.unit(i)
        harness._sync(device)
        b = time.perf_counter()
        rec["seconds"] = b - a
        run.units.append(rec)
        i += 1
        if rank == 0:
            stop[0] = int((deadline is not None and b >= deadline)
                          or (count is not None and i >= count))
        dist.broadcast(stop, src=0, group=book)
        if stop[0]:
            break
    run.window_s = time.perf_counter() - t0
    cpu1, steal1 = os.times(), harness._cpu_steal()
    run.host = {"process_cpu_s": (cpu1.user + cpu1.system)
                - (cpu0.user + cpu0.system),
                "machine_steal_s": steal1 - steal0}
    after = driver.counters()
    run.counters = {k: after[k] - before.get(k, 0) for k in after}


def _traced_units(driver, run, count: int, device, workdir: str, book,
                  rank: int) -> Dict:
    """``count`` units in lockstep under this rank's profiler; returns
    :func:`harness.read_trace` of this rank's trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        # a profiler takes its own time to start: the windows open together
        # only once every rank's is on
        dist.barrier(group=book)
        with torch.profiler.record_function("bench.window"):
            _lockstep_units(driver, run, None, count, device, book, rank)
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return harness.read_trace(path, run)
    finally:
        os.remove(path)


def _rank_record(rank: int, device, run, trace: bool) -> Dict:
    """What rank 0 gathers of this rank: its card, its memory peak on
    every card it allocated on, its units and counters, its trace."""
    rec = {"rank": rank, "units": run.units, "counters": run.counters,
           "kernels": run.kernels, "device_busy_s": run.device_busy_s,
           "trace_window_s": run.trace_window_s if trace else None,
           "card": None, "memory_peak_bytes": 0, "allocated": {}}
    dev = torch.device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        rec.update(card=dev.index, uuid=str(props.uuid), kind=props.name,
                   memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)))
        for d in range(torch.cuda.device_count()):
            peak = int(torch.cuda.max_memory_allocated(d))
            if peak > 0:
                uuid = str(torch.cuda.get_device_properties(d).uuid)
                rec["allocated"][uuid] = peak
    return rec


def _merge_ranks(run, ranks: List[Dict], setup_s: float, cuda: bool
                 ) -> Dict:
    """On rank 0: each unit's ``seconds`` the slowest rank's, ``run.ranks``,
    the window's unit statistics, and the device facts of every card."""
    counts = {len(r["units"]) for r in ranks}
    if len(counts) != 1:
        raise RuntimeError(f"the ranks ran different numbers of units: "
                           f"{[len(r['units']) for r in ranks]}")
    for i, rec in enumerate(run.units):
        rec["seconds"] = max(r["units"][i]["seconds"] for r in ranks)
    run.ranks = ranks
    run.setup_s = setup_s
    secs = sorted(u["seconds"] for u in run.units)
    run.host = {"units": len(secs), "unit_s_min": secs[0],
                "unit_s_median": secs[len(secs) // 2],
                "unit_s_max": secs[-1], **run.host}
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": len(ranks),
                "memory_peak_bytes": 0}
    kinds = sorted({r["kind"] for r in ranks})
    if len(kinds) != 1:
        raise RuntimeError(f"the ranks' cards differ: {kinds}")
    per_card: Dict[str, int] = {}
    for r in ranks:
        for uuid, peak in r["allocated"].items():
            per_card[uuid] = per_card.get(uuid, 0) + peak
    return {"platform": "gpu", "kind": kinds[0], "count": len(per_card),
            "memory_peak_bytes": max(per_card.values(), default=0)}


def _rank_summary(rec: Dict, trace: bool) -> Dict:
    """One rank's entry of the result's ``window.ranks``."""
    out = {"rank": rec["rank"], "card": rec["card"],
           "memory_peak_bytes": rec["memory_peak_bytes"],
           "units": len(rec["units"])}
    if trace:
        out["busy_s"] = rec["device_busy_s"]
        out["window_s"] = rec["trace_window_s"]
    return out

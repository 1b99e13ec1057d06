"""Start a world of local ranks, one process each.

:func:`run_world` starts ``size`` processes with the ``spawn`` start
method (never ``fork``: the caller may hold CUDA or JAX state), each with
one intra-op thread, joins them into one ``torch.distributed`` world by
:func:`~.multihost.initialize_multihost` on a free localhost port, calls
``fn(rank, size, *args)`` in each, and returns each rank's result (numpy
and Python values: they are pickled back).  A rank that raises fails the
world: the others are killed and the rank's traceback is raised here; so
does a rank that dies without a result, and a world that outlives its
timeout.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

__all__ = ["run_world", "free_port"]


def free_port() -> int:
    """A TCP port free on localhost at the time of the call."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, size: int, port: int, device, backend,
               threads: int, inputs, results) -> None:
    import torch
    import torch.distributed as dist

    from .multihost import initialize_multihost

    torch.set_num_threads(threads)
    try:
        args = inputs.get()
        initialize_multihost(f"localhost:{port}", size, rank, device=device,
                             backend=backend)
        try:
            out = fn(rank, size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_world(fn: Callable, size: int, args: Sequence[Any] = (),
              device: Optional[str] = None, backend: Optional[str] = None,
              timeout_s: float = 600.0, threads: int = 1) -> List[Any]:
    """``[fn(0, size, *args), ..., fn(size - 1, size, *args)]``, each run
    in its own rank of a fresh world (see the module doc).  ``fn`` must be
    importable by name (a module-level function).  ``device`` and
    ``backend`` choose the world's backend as a mesh's are chosen:
    ``None`` is the card and NCCL (raising here, before any rank starts,
    when there is no card), ``"cpu"`` gloo, the card with
    ``backend="gloo"`` gloo staged through the host."""
    from .._device import resolve_device

    resolve_device(device)
    ctx = mp.get_context("spawn")
    results, inputs = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, size, port, device, backend, threads,
                               inputs, results), daemon=True)
             for r in range(size)]
    # the arguments go through a queue (its feeder thread writes them as
    # the ranks read): in a process's own start-up pipe they would make
    # each start wait for the rank before it to finish importing
    for p in procs:
        p.start()
        inputs.put(tuple(args))
    out: List[Any] = [None] * size
    pending = set(range(size))
    deadline = time.monotonic() + timeout_s
    try:
        while pending:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r in pending if procs[r].exitcode is not None]
                if dead:
                    raise RuntimeError(f"ranks {dead} of {size} exited "
                                       f"without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(pending)} of {size} "
                                       f"still running after {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {size} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            p.join(timeout=60)
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        inputs.close()

"""Every collective of the distributed layer, in one place.

The JAX package runs single-program ``shard_map`` bodies with ``psum`` /
``pmin`` / ``pmax`` / ``all_to_all`` / ``ppermute`` inside; the port is
multi-process SPMD, one rank per device, and this module is its only caller
of ``torch.distributed``:

* :func:`all_reduce` — ``psum`` / ``pmin`` / ``pmax``;
* :func:`all_gather` and :func:`all_gather_tree` — the global view of a
  per-shard value (``(size,) + shape``), the same on every rank;
* :func:`all_to_all` — ``all_to_all(x, axis, 0, 0, tiled=False)`` on an
  ``(n, slot, ...)`` buffer, as ``all_to_all_single`` over its rows;
* :func:`ring_exchange` — the ``ppermute`` ring pair (to rank + 1 and to
  rank - 1) as ``batch_isend_irecv``; in a world of one the ring neighbour
  is the rank itself and the exchange is a local copy, as ``ppermute`` with
  pairs ``[(0, 0)]`` is.

Each collective takes a 1-D mesh — a mesh's line along the op's axis
(:meth:`~.mesh.Mesh.along`), or a 1-D mesh itself — and runs on its group;
"rank" below is the index on that line, and a point-to-point peer is named
by its global rank (``dist.get_global_rank``).

A NCCL mesh takes device tensors directly.  A gloo mesh on the card (the
four-rank world that shares one card) stages each tensor through host
memory here and nowhere else: an explicit ``.cpu()`` before the collective
and ``.to(device)`` after it.  Calls, payload bytes and staged bytes are
counted (:func:`collective_counts`), for ``chip_smoke.py`` and the tests.
Nothing falls back: a collective that fails raises.

Several tensors that travel together are packed into one byte buffer
(:func:`pack` / :func:`unpack`), so a partition's columns and its counts
cross in one call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather", "all_gather_tree", "all_to_all",
           "ring_exchange", "pack", "unpack", "collective_counts",
           "reset_collective_counts", "COUNTS", "STAGED"]

#: per collective: calls and the bytes this rank handed to it
COUNTS: Dict[str, Dict[str, int]] = {
    name: {"calls": 0, "bytes": 0}
    for name in ("all_reduce", "all_gather", "all_to_all", "ring")}
#: bytes a gloo mesh on the card copied to the host and back
STAGED: Dict[str, int] = {"to_host_bytes": 0, "to_device_bytes": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}
_ALIGN = 8


def collective_counts() -> Dict[str, Any]:
    """A copy of the counters: ``{collective: {"calls", "bytes"}, "staged":
    {"to_host_bytes", "to_device_bytes"}}``."""
    out: Dict[str, Any] = {k: dict(v) for k, v in COUNTS.items()}
    out["staged"] = dict(STAGED)
    return out


def reset_collective_counts() -> None:
    """Set every collective and staging counter to 0."""
    for v in COUNTS.values():
        v["calls"] = v["bytes"] = 0
    for k in STAGED:
        STAGED[k] = 0


def _count(name: str, nbytes: int) -> None:
    COUNTS[name]["calls"] += 1
    COUNTS[name]["bytes"] += int(nbytes)


def _to_wire(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.contiguous()
    if mesh.staged:
        STAGED["to_host_bytes"] += t.numel() * t.element_size()
        return t.cpu()
    return t


def _from_wire(t: torch.Tensor, mesh) -> torch.Tensor:
    if mesh.staged:
        STAGED["to_device_bytes"] += t.numel() * t.element_size()
        return t.to(mesh.device)
    return t


def all_reduce(t: torch.Tensor, op: str, mesh) -> torch.Tensor:
    """``op`` ("sum", "min" or "max") of ``t`` over the mesh; a new
    tensor, the same on every rank."""
    _count("all_reduce", t.numel() * t.element_size())
    w = _to_wire(t, mesh).clone()
    dist.all_reduce(w, op=_OPS[op], group=mesh.group)
    return _from_wire(w, mesh)


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """``(size,) + t.shape``: every rank's ``t`` in rank order."""
    _count("all_gather", t.numel() * t.element_size())
    w = _to_wire(t, mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    return _from_wire(torch.stack(parts), mesh)


def all_to_all(t: torch.Tensor, mesh) -> torch.Tensor:
    """Row block ``d`` of ``t`` (``size`` equal blocks along dim 0) goes to
    rank ``d``; block ``s`` of the result came from rank ``s``."""
    _count("all_to_all", t.numel() * t.element_size())
    w = _to_wire(t, mesh)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group)
    return _from_wire(out, mesh)


def ring_exchange(to_right: torch.Tensor, to_left: torch.Tensor, mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``to_right`` to rank + 1 and ``to_left`` to rank - 1 (mod
    size); returns ``(from_left, from_right)``: what rank - 1 sent right
    and what rank + 1 sent left."""
    _count("ring", (to_right.numel() * to_right.element_size()
                    + to_left.numel() * to_left.element_size()))
    if mesh.size == 1:
        return to_right.clone(), to_left.clone()
    right = dist.get_global_rank(mesh.group, (mesh.rank + 1) % mesh.size)
    left = dist.get_global_rank(mesh.group, (mesh.rank - 1) % mesh.size)
    sr, sl = _to_wire(to_right, mesh), _to_wire(to_left, mesh)
    from_left, from_right = torch.empty_like(sr), torch.empty_like(sl)
    # tags keep the two directions apart where left == right (two ranks)
    ops = [dist.P2POp(dist.isend, sr, right, mesh.group, 0),
           dist.P2POp(dist.isend, sl, left, mesh.group, 1),
           dist.P2POp(dist.irecv, from_left, left, mesh.group, 0),
           dist.P2POp(dist.irecv, from_right, right, mesh.group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _from_wire(from_left, mesh), _from_wire(from_right, mesh)


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def pack(tensors: Sequence[torch.Tensor], lead: int
         ) -> Tuple[torch.Tensor, List[Tuple]]:
    """Tensors that share a leading dimension ``lead`` as one ``(lead, B)``
    uint8 buffer, each tensor's bytes of a row side by side (offsets kept
    8-byte aligned, ``B`` a multiple of 8).  Returns ``(buffer, layout)``
    for :func:`unpack`."""
    cols, layout, off = [], [], 0
    for t in tensors:
        t = t.contiguous()
        nb = (t.numel() // lead) * t.element_size() if lead else 0
        cols.append(t.reshape(lead, -1).view(torch.uint8)
                    if t.numel() else t.new_zeros((lead, 0),
                                                  dtype=torch.uint8))
        pad = _round_up(nb, _ALIGN) - nb
        if pad:
            cols.append(cols[-1].new_zeros((lead, pad)))
        layout.append((t.dtype, tuple(t.shape[1:]), off, nb))
        off += nb + pad
    if not cols:
        return torch.zeros((lead, 0), dtype=torch.uint8), layout
    return torch.cat(cols, dim=1), layout


def unpack(buf: torch.Tensor, layout: Sequence[Tuple]
           ) -> List[torch.Tensor]:
    """The tensors of a :func:`pack` buffer (its leading dimension may have
    changed, as after an exchange of whole rows)."""
    lead = buf.shape[0]
    out = []
    for dtype, shape, off, nb in layout:
        raw = buf[:, off:off + nb].contiguous()
        out.append(raw.view(dtype).reshape((lead,) + shape))
    return out


def _leaves(tree, out: List[torch.Tensor]):
    if isinstance(tree, dict):
        return {k: _leaves(v, out) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_leaves(v, out) for v in tree)
    out.append(tree)
    return len(out) - 1


def _rebuild(skeleton, leaves: List[torch.Tensor]):
    if isinstance(skeleton, dict):
        return {k: _rebuild(v, leaves) for k, v in skeleton.items()}
    if isinstance(skeleton, tuple):
        return tuple(_rebuild(v, leaves) for v in skeleton)
    return leaves[skeleton]


def all_gather_tree(tree, mesh) -> List:
    """Every rank's ``tree`` (nested dicts / tuples of tensors on the mesh
    device, the same structure and shapes on every rank) in rank order, in
    one :func:`all_gather` of their packed bytes.  Every tensor goes whole,
    at its full shape: a batch's rows past its count travel too (the
    sharded merged voxelize hands over its stage-1 batch and aux at their
    capacity rows: 1 155 004 928 bytes a rank on a 15 000 064-row shard,
    77 a row)."""
    leaves: List[torch.Tensor] = []
    skeleton = _leaves(tree, leaves)
    flat = [t.reshape((1,) + tuple(t.shape)) for t in leaves]
    buf, layout = pack(flat, 1)
    rows = all_gather(buf[0], mesh)
    out = []
    for r in range(mesh.size):
        got = unpack(rows[r:r + 1], layout)
        out.append(_rebuild(skeleton, [g[0] for g in got]))
    return out

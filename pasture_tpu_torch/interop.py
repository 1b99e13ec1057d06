"""State carried across from the JAX package.

The port imports nothing of the JAX package, so a batch crosses over as
plain numpy: the caller turns each JAX array into ``numpy`` (the tests do
``np.asarray(jax_array)``) and these functions build the port's own
:class:`PointBatch` — with the port's own :class:`PointSchema`, found by
attribute name — or its own ``PoseGraph``, and go back.  Point clouds cross
as ``(N, 3)`` numpy.

The distributed layer's state crosses per rank: a JAX array sharded over a
mesh axis is one global array whose leading axis holds the shards in
order, and :func:`shards_from_reference` cuts it into the ranks' blocks
(:func:`shards_to_reference` joins them back).  On a mesh of several axes
the array is sharded over one of them and replicated over the others:
given the mesh's ``shape`` and the ``axis``, the carriers give every rank
of the mesh (row-major) the block of its coordinate on the axis, and join
one line's blocks back.  The merge statistics have their own carrier; a
``MortonPartitionSpec`` is replicated over every axis and crosses whole.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ._device import resolve_device
from .buffers.device import PointBatch
from .layout import attributes as att
from .layout.dtypes import DevicePolicy, carrier_np_dtype
from .layout.schema import PointSchema

__all__ = ["batch_from_reference_arrays", "batch_to_reference_arrays",
           "aux_from_reference", "aux_to_reference",
           "affine_from_reference", "head_args_from_reference",
           "pose_graph_from_reference", "pose_graph_to_reference",
           "shards_from_reference", "shards_to_reference",
           "aux_shards_from_reference", "spec_from_reference",
           "spec_to_reference"]

_BUILTIN = {a.name: a for a in att.BUILTIN_ATTRIBUTES}


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)


def _schema_of(attribute_names: Sequence[str]) -> PointSchema:
    missing = [n for n in attribute_names if n not in _BUILTIN]
    if missing:
        raise KeyError(f"no builtin attribute named {missing}")
    return PointSchema.from_attributes([_BUILTIN[n] for n in attribute_names])


def batch_from_reference_arrays(
        columns: Mapping[str, np.ndarray], count: int,
        attribute_names: Sequence[str],
        meta: Optional[Mapping[str, np.ndarray]] = None,
        device: Optional[Union[str, torch.device]] = None,
        policy: DevicePolicy = DevicePolicy.NARROW) -> PointBatch:
    """The port's batch from the numpy arrays of a JAX ``PointBatch``:
    ``columns`` in the JAX batch's device dtypes (a u16 column as uint16, a
    u32 word as uint32), ``count`` its valid rows, ``attribute_names`` the
    names of its schema in order.  ``device=None`` means the GPU."""
    dev = resolve_device(device)
    data = {}
    for name, col in columns.items():
        col = np.asarray(col)
        host = np.ascontiguousarray(col.astype(carrier_np_dtype(col.dtype)))
        data[name] = torch.from_numpy(host).to(dev)
    meta_t = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v))).to(dev)
              for k, v in (meta or {}).items()}
    return PointBatch(data, torch.tensor(int(count), dtype=torch.int32,
                                         device=dev),
                      _schema_of(attribute_names), meta_t, policy)


def batch_to_reference_arrays(batch: PointBatch
                              ) -> Tuple[Dict[str, np.ndarray], int,
                                         Tuple[str, ...],
                                         Dict[str, np.ndarray]]:
    """``(columns, count, attribute_names, meta)`` as numpy, each column
    back in its logical device dtype — what ``jnp.asarray`` needs to
    rebuild the JAX batch."""
    cols = {}
    for name, t in batch.data.items():
        arr = t.detach().cpu().numpy()
        with np.errstate(over="ignore"):
            cols[name] = arr.astype(batch.logical_dtype(name))
    meta = {k: v.detach().cpu().numpy() for k, v in batch.meta.items()}
    return cols, int(batch.count.item()), batch.schema.names, meta


def aux_from_reference(aux: Mapping,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Dict:
    """The port's merge statistics from the numpy arrays of a JAX ``aux``
    dict (``voxel_downsample(with_aux=True)`` or ``merge_voxel_batches``):
    the u32 cell keys become int64 carriers, the i32 columns int32, the
    mode dicts, the run tables (``num_runs`` and ``input_truncated`` as 0-d
    tensors) and ``raw_means`` keep their structure.  ``device=None`` means
    the GPU."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        a = np.array(x)
        if a.dtype.kind in "iu":
            a = a.astype(carrier_np_dtype(a.dtype))
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return conv(aux)


def aux_to_reference(aux: Mapping) -> Dict:
    """``aux`` of the port as numpy in the JAX package's dtypes — what
    ``jnp.asarray`` needs to rebuild it: cell keys back to uint32, the
    other integer columns int32, 0-d values as 0-d arrays."""
    def conv(x, key=False):
        if isinstance(x, Mapping):
            return {k: conv(v, k == "keys") for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v, key) for v in x)
        a = x.detach().cpu().numpy()
        if key:
            return a.astype(np.uint32)
        return a.astype(np.int32) if a.dtype.kind in "iu" else a

    return conv(aux)


def affine_from_reference(scale, rot, trans, coeffs,
                          device: Optional[Union[str, torch.device]] = None):
    """``local_affine=(scale, rot, trans, coeffs)`` of the JAX package as
    tensors for the port (f32, f32, f32, int32)."""
    dev = resolve_device(device)
    return (_f32(scale, dev).reshape(3), _f32(rot, dev).reshape(3, 3),
            _f32(trans, dev).reshape(3),
            torch.from_numpy(np.array(coeffs, dtype=np.int32)).to(dev))


def head_args_from_reference(scale, rot, trans, bounds_min, leaf_size,
                             device: Optional[Union[str, torch.device]] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor, float]:
    """``(scale, rotation, translation, bounds_min, leaf_size)`` of a JAX
    head call (``fused_voxel_head``, ``fused_decode_transform_key``) as the
    port's head arguments: four f32 tensors on ``device`` and the leaf as a
    Python float."""
    dev = resolve_device(device)
    return (_f32(scale, dev).reshape(3), _f32(rot, dev).reshape(3, 3),
            _f32(trans, dev).reshape(3), _f32(bounds_min, dev).reshape(3),
            float(leaf_size))


def pose_graph_from_reference(rotations, translations, edges, rel_rotations,
                              rel_translations, weights=None,
                              device: Optional[Union[str, torch.device]]
                              = None):
    """The port's :class:`~pasture_tpu_torch.registration.PoseGraph` from the
    numpy arrays of a JAX ``PoseGraph`` (rotations (N, 3, 3), translations
    (N, 3), edges (E, 2), relative rotations (E, 3, 3) and translations
    (E, 3), optional weights (E,)).  Float arrays keep their dtype, edges
    become int64.  ``device=None`` means the GPU."""
    from .registration import PoseGraph

    dev = resolve_device(device)

    def f(a):
        return torch.from_numpy(np.array(a)).to(dev)

    return PoseGraph(f(rotations), f(translations),
                     f(np.asarray(edges, np.int64)), f(rel_rotations),
                     f(rel_translations),
                     None if weights is None else f(weights))


def pose_graph_to_reference(graph) -> Tuple[np.ndarray, ...]:
    """``(rotations, translations, edges, rel_rotations, rel_translations,
    weights)`` of a port ``PoseGraph`` as numpy — what ``jnp.asarray`` needs
    to rebuild the JAX ``PoseGraph``; ``weights`` is ``None`` when the graph
    has none, edges are int32 as the JAX package keeps them."""
    def f(t):
        return t.detach().cpu().numpy()

    return (f(graph.rotations), f(graph.translations),
            f(graph.edges).astype(np.int32), f(graph.rel_rotations),
            f(graph.rel_translations),
            None if graph.weights is None else f(graph.weights))


def _line_coords(size, axis: Optional[str]):
    """``(axis length, per-rank coordinate on the axis)`` of a 1-D size or
    of a mesh's ``shape`` dict and one of its axes."""
    if not isinstance(size, Mapping):
        return int(size), list(range(int(size)))
    names = list(size)
    if axis not in names:
        raise ValueError(f"axis {axis!r} is not one of {names}")
    dims = tuple(int(size[k]) for k in names)
    coords = np.unravel_index(np.arange(int(np.prod(dims))), dims)
    return dims[names.index(axis)], coords[names.index(axis)].tolist()


def shards_from_reference(array, size, axis: Optional[str] = None) -> list:
    """The per-rank blocks of a JAX array sharded over its leading axis
    (global view ``(n·per, ...)``), as numpy.  ``size`` is the axis's
    length ``n`` (one block a rank), or a mesh's ``shape`` dict with
    ``axis`` the sharded axis: then one block for every rank of the mesh
    in rank order, each the block of its coordinate on ``axis``."""
    n, coords = _line_coords(size, axis)
    a = np.asarray(array)
    if a.shape[0] % n:
        raise ValueError(f"{a.shape[0]} rows do not split into {n}")
    blocks = np.split(a, n)
    return [blocks[c] for c in coords]


def shards_to_reference(blocks: Sequence, shape: Optional[Mapping] = None,
                        axis: Optional[str] = None) -> np.ndarray:
    """The global view of per-rank blocks: their concatenation in rank
    order, as numpy.  With a mesh's ``shape`` and the sharded ``axis``,
    ``blocks`` holds every rank's block (rank order) and the global view
    is the line through rank 0 along ``axis`` (the other lines hold the
    same blocks: the array is replicated over the other axes)."""
    if shape is not None:
        names = list(shape)
        dims = tuple(int(shape[k]) for k in names)
        coords = np.unravel_index(np.arange(len(blocks)), dims)
        a = names.index(axis)
        blocks = [b for r, b in enumerate(blocks)
                  if all(coords[d][r] == 0 for d in range(len(dims))
                         if d != a)]
    return np.concatenate([np.asarray(b) for b in blocks])


def aux_shards_from_reference(aux: Mapping, size,
                              axis: Optional[str] = None) -> list:
    """The per-rank merge statistics of a sharded JAX ``aux`` dict
    (``sharded_voxel_downsample(with_aux=True)``'s global view) as numpy
    trees: every leaf cut into its ``size`` blocks, and each run table's
    ``num_runs`` — one entry a shard in the global view — back to the 0-d
    counter of a single-device ``aux``.  ``size`` and ``axis`` as in
    :func:`shards_from_reference`.  Feed each to
    :func:`aux_from_reference`."""
    def cut(x, key=None):
        if isinstance(x, Mapping):
            return [dict(zip(x, vals)) for vals in
                    zip(*(cut(v, k) for k, v in x.items()))]
        if isinstance(x, (tuple, list)):
            return [tuple(vals) for vals in zip(*(cut(v) for v in x))]
        blocks = shards_from_reference(x, size, axis)
        return [b.reshape(()) for b in blocks] if key == "num_runs" \
            else blocks

    return cut(aux)


def spec_from_reference(gmin, extent, dest_of_bucket,
                        device: Optional[Union[str, torch.device]] = None):
    """The port's :class:`~pasture_tpu_torch.parallel.MortonPartitionSpec`
    from the numpy arrays of a JAX one (floats keep their dtype, the
    bucket map becomes int64).  ``device=None`` means the GPU."""
    from .parallel import MortonPartitionSpec

    dev = resolve_device(device)
    return MortonPartitionSpec(
        torch.from_numpy(np.array(gmin)).to(dev),
        torch.from_numpy(np.array(extent)).to(dev),
        torch.from_numpy(np.asarray(dest_of_bucket, np.int64)).to(dev))


def spec_to_reference(spec) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(gmin, extent, dest_of_bucket)`` of a port spec as numpy, the
    bucket map int32 as the JAX package keeps it."""
    return (spec.gmin.detach().cpu().numpy(),
            spec.extent.detach().cpu().numpy(),
            spec.dest_of_bucket.detach().cpu().numpy().astype(np.int32))

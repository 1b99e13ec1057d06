"""Device-resident point batches (SoA dicts of torch tensors).

A :class:`PointBatch` holds one tensor per attribute (always columnar —
reference pasture-core/src/containers/point_buffer.rs's ``HashMapBuffer``
is the closest analog) plus a validity ``count``.  Columns are padded to a
fixed ``capacity`` so that every op works on whole columns without host
round trips; reductions mask out the tail.

* Each column is stored in the *carrier* torch dtype of its logical dtype
  (:data:`pasture_tpu_torch.layout.dtypes.CARRIER_OF`): unsigned 16/32-bit
  values ride in int32/int64.  :meth:`PointBatch.logical_dtype` recovers the
  logical dtype (from the schema and the batch's ``policy``); ``to_host``
  casts back to the schema's exact numpy dtypes.
* ``count`` is a 0-d int32 tensor on the batch's device; it is read to the
  host only in :meth:`PointBatch.to_host`.
* Exactness-critical position math uses LAS-native ``i32`` local
  coordinates + a scale/offset, as the LAS format itself does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from ..layout.attributes import PointAttribute
from ..layout.dtypes import DevicePolicy, carrier_np_dtype
from ..layout.schema import PointSchema
from .host import HostPointBuffer

__all__ = ["PointBatch"]


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _pad_rows(t: torch.Tensor, extra: int) -> torch.Tensor:
    if extra == 0:
        return t
    return torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))], dim=0)


@dataclasses.dataclass
class PointBatch:
    """N points as SoA device tensors, padded to ``capacity``.

    ``data[name]`` has shape ``(capacity,)`` or ``(capacity, C)``;
    ``count`` is a 0-d int32 tensor with the number of valid points;
    ``meta`` holds small per-batch tensors (e.g. position scale/offset).
    ``schema`` describes the *logical* (host) dtypes; ``policy`` is the
    :class:`DevicePolicy` the columns were narrowed under.
    """

    data: Dict[str, torch.Tensor]
    count: torch.Tensor
    schema: PointSchema
    meta: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    policy: DevicePolicy = DevicePolicy.NARROW

    # ---- constructors ---------------------------------------------------------
    @classmethod
    def from_host(
        cls,
        buffer: HostPointBuffer,
        policy: DevicePolicy = DevicePolicy.NARROW,
        capacity: Optional[int] = None,
        pad_multiple: int = 8,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "PointBatch":
        """Upload a host buffer.  ``device=None`` means the GPU (raises
        without one); pass ``device="cpu"`` to stay on the CPU."""
        dev = resolve_device(device)
        n = len(buffer)
        cap = capacity if capacity is not None else max(
            _round_up(max(n, 1), pad_multiple), pad_multiple)
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        data = {}
        for m in buffer.schema.members:
            logical = policy.np_dtype(m.dtype)
            with np.errstate(over="ignore", invalid="ignore"):
                host = buffer.columns[m.name].astype(logical)
            host = np.ascontiguousarray(host.astype(carrier_np_dtype(logical)))
            data[m.name] = _pad_rows(torch.from_numpy(host).to(dev), cap - n)
        count = torch.tensor(n, dtype=torch.int32, device=dev)
        return cls(data, count, buffer.schema, {}, policy)

    @classmethod
    def from_columns(
        cls, schema: PointSchema, columns: Dict[str, torch.Tensor],
        count: Optional[Union[int, torch.Tensor]] = None,
        meta: Optional[Dict[str, torch.Tensor]] = None,
        policy: DevicePolicy = DevicePolicy.NARROW,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "PointBatch":
        """Batch from carrier-dtype columns (tensors, moved to ``device``;
        ``None`` means the GPU and raises without one)."""
        dev = resolve_device(device)
        data = {k: torch.as_tensor(v).to(dev) for k, v in columns.items()}
        cap = None
        for v in data.values():
            cap = v.shape[0]
            break
        if count is None:
            count = cap if cap is not None else 0
        return cls(data, _as_count(count, dev), schema,
                   {k: torch.as_tensor(v).to(dev)
                    for k, v in (meta or {}).items()}, policy)

    # ---- queries --------------------------------------------------------------
    @property
    def capacity(self) -> int:
        for v in self.data.values():
            return v.shape[0]
        return 0

    @property
    def device(self) -> torch.device:
        return self.count.device

    def __len__(self) -> int:
        return self.capacity

    def get(self, attribute: Union[str, PointAttribute]) -> torch.Tensor:
        name = attribute if isinstance(attribute, str) else attribute.name
        return self.data[name]

    def valid_mask(self) -> torch.Tensor:
        """Boolean (capacity,) mask of valid points."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.count

    def logical_dtype(self, name: str) -> np.dtype:
        """Logical device dtype of column ``name``: float columns are what
        their tensor says; integer columns named in the schema take the
        schema's dtype under ``policy``; any other column is its carrier."""
        t = self.data[name].dtype
        member = self.schema.get(name)
        if t.is_floating_point or member is None \
                or member.dtype.kind not in ("uint", "int"):
            return np.dtype(str(t).replace("torch.", ""))
        return self.policy.np_dtype(member.dtype)

    # ---- functional updates ---------------------------------------------------
    def _replace(self, **kw) -> "PointBatch":
        return dataclasses.replace(self, **kw)

    def with_column(self, name: str, values: torch.Tensor) -> "PointBatch":
        data = dict(self.data)
        data[name] = values
        return self._replace(data=data)

    def with_meta(self, name: str, value: torch.Tensor) -> "PointBatch":
        meta = dict(self.meta)
        meta[name] = value
        return self._replace(meta=meta)

    def with_count(self, count) -> "PointBatch":
        return self._replace(count=_as_count(count, self.device))

    def gather(self, indices: torch.Tensor, count=None) -> "PointBatch":
        """Row gather: reorder/select points by index."""
        idx = indices.to(torch.int64)
        data = {k: v.index_select(0, idx) for k, v in self.data.items()}
        out = self._replace(data=data)
        return out if count is None else out.with_count(count)

    def pad_to(self, capacity: int) -> "PointBatch":
        if capacity < self.capacity:
            raise ValueError("pad_to cannot shrink; use slice")
        extra = capacity - self.capacity
        return self._replace(
            data={k: _pad_rows(v, extra) for k, v in self.data.items()})

    @classmethod
    def concatenate(cls, batches: Sequence["PointBatch"],
                    compact: bool = True) -> "PointBatch":
        """Concat along the point axis (capacity: the sum of the inputs').

        By default the result is *compacted*: the valid rows of every input
        move to the front, stable (original order preserved), in one
        ``compact_columns`` call over all columns — the compaction kernel
        on a CUDA batch — so the result holds the ``rows [0, count)``
        invariant even when inputs carry padding; rows past the count are
        zero.  ``compact=False`` keeps the raw layout (cheaper, but the
        caller asserts every input is full).  The count stays on the
        device."""
        first = batches[0]
        names = list(first.data)
        data = {k: torch.cat([b.data[k] for b in batches], dim=0)
                for k in names}
        if compact:
            from ..ops.compact import compact_columns

            keep = torch.cat([b.valid_mask() for b in batches])
            cols, count = compact_columns([data[k] for k in names], keep)
            data = dict(zip(names, cols))
        else:
            count = torch.stack([b.count for b in batches]).sum().to(
                torch.int32)
        return cls(data, count, first.schema, first.meta, first.policy)

    # ---- host transfer --------------------------------------------------------
    def to_host(self, trim: bool = True) -> HostPointBuffer:
        """Copy back to host, casting to the schema's exact numpy dtypes."""
        n = int(self.count.item())
        cols = {}
        for m in self.schema.members:
            arr = self.data[m.name].detach().cpu().numpy()
            if trim:
                arr = arr[:n]
            with np.errstate(over="ignore", invalid="ignore"):
                cols[m.name] = np.ascontiguousarray(
                    arr.astype(m.dtype.np_component_dtype))
        return HostPointBuffer(self.schema, cols, validate=False)

    def __repr__(self) -> str:
        return (f"PointBatch(capacity={self.capacity}, "
                f"attrs={sorted(self.data)}, meta={sorted(self.meta)}, "
                f"device={self.device})")


def _as_count(count, device) -> torch.Tensor:
    if isinstance(count, torch.Tensor):
        return count.to(device=device, dtype=torch.int32).reshape(())
    return torch.tensor(int(count), dtype=torch.int32, device=device)

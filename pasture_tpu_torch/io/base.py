"""I/O base traits + factory.

Parity with pasture-io/src/base/: ``PointReader`` (reader.rs:7-38),
``PointWriter`` (writer.rs:5-14), ``SeekToPoint`` (seek.rs:7-26),
extension-dispatched factory (io_factory.rs:22-166) and the convenience
``read_all``/``write_all`` helpers (mod.rs:28-79).
"""

from __future__ import annotations

import abc
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

from ..buffers.host import HostPointBuffer
from ..layout.schema import PointSchema
from ..math.aabb import AABB

__all__ = [
    "Metadata", "PointReader", "PointWriter", "SeekToPoint", "IOFactory",
    "DEFAULT_FACTORY", "open_reader", "open_writer", "point_count",
    "read_all", "read_all_into", "write_all",
]


class Metadata(abc.ABC):
    """Format-agnostic metadata (reference meta/metadata.rs:9-20)."""

    @abc.abstractmethod
    def bounds(self) -> Optional[AABB]: ...

    @abc.abstractmethod
    def number_of_points(self) -> Optional[int]: ...

    @abc.abstractmethod
    def get_named_field(self, name: str) -> Optional[Any]: ...


class PointReader(abc.ABC):
    """Streaming point reader with layout conversion on read."""

    @abc.abstractmethod
    def read(self, count: int, schema: Optional[PointSchema] = None
             ) -> HostPointBuffer:
        """Read up to ``count`` points.  Without ``schema`` the reader's
        default schema is used; otherwise the data is converted
        (reference ``PointReader::read``/``read_into``, base/reader.rs:7-38)."""

    @abc.abstractmethod
    def get_metadata(self) -> Metadata: ...

    @abc.abstractmethod
    def get_default_point_schema(self) -> PointSchema: ...

    def read_all(self, schema: Optional[PointSchema] = None) -> HostPointBuffer:
        n = self.get_metadata().number_of_points()
        return self.read(n if n is not None else 2**63, schema)

    # context manager sugar
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        close = getattr(self, "close", None)
        if close:
            close()
        return False


class PointWriter(abc.ABC):
    """Streaming point writer; ``flush`` finalises headers
    (reference base/writer.rs:5-14)."""

    @abc.abstractmethod
    def write(self, buffer: HostPointBuffer) -> None: ...

    @abc.abstractmethod
    def flush(self) -> None: ...

    @abc.abstractmethod
    def get_default_point_schema(self) -> PointSchema: ...

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.flush()
        close = getattr(self, "close", None)
        if close:
            close()
        return False


class SeekToPoint(abc.ABC):
    """Point-granular seeking (reference base/seek.rs:7-26)."""

    @abc.abstractmethod
    def seek_point(self, index: int) -> int: ...

    def point_index(self) -> int:
        raise NotImplementedError

    def point_count(self) -> int:
        raise NotImplementedError


class IOFactory:
    """Extension-based reader/writer dispatch
    (reference base/io_factory.rs:22-166).  Formats self-register at import."""

    def __init__(self) -> None:
        self._readers: Dict[str, Callable[[Union[str, Path]], PointReader]] = {}
        self._writers: Dict[str, Callable[..., PointWriter]] = {}

    def register_reader(self, extension: str, opener) -> None:
        self._readers[extension.lower().lstrip(".")] = opener

    def register_writer(self, extension: str, opener) -> None:
        self._writers[extension.lower().lstrip(".")] = opener

    def supports_reading_from(self, path: Union[str, Path]) -> bool:
        return Path(path).suffix.lower().lstrip(".") in self._readers

    def supports_writing_to(self, path: Union[str, Path]) -> bool:
        return Path(path).suffix.lower().lstrip(".") in self._writers

    def make_reader(self, path: Union[str, Path]) -> PointReader:
        ext = Path(path).suffix.lower().lstrip(".")
        if ext not in self._readers:
            raise ValueError(f"no reader registered for extension {ext!r}")
        return self._readers[ext](path)

    def make_writer(self, path: Union[str, Path], schema: PointSchema,
                    **kwargs) -> PointWriter:
        ext = Path(path).suffix.lower().lstrip(".")
        if ext not in self._writers:
            raise ValueError(f"no writer registered for extension {ext!r}")
        return self._writers[ext](path, schema, **kwargs)


DEFAULT_FACTORY = IOFactory()


def open_reader(path: Union[str, Path]) -> PointReader:
    """``GenericPointReader::open_file`` equivalent (io_factory.rs:54-66)."""
    return DEFAULT_FACTORY.make_reader(path)


def open_writer(path: Union[str, Path], schema: PointSchema, **kw) -> PointWriter:
    """Create a :class:`PointWriter` for ``path`` via the default
    extension registry (reference IOFactory, base/io_factory.rs)."""
    return DEFAULT_FACTORY.make_writer(path, schema, **kw)


def point_count(path: Union[str, Path]) -> Optional[int]:
    """Number of points in a file without reading them
    (reference IOFactory::point_count, io_factory.rs:148-166)."""
    with open_reader(path) as r:
        return r.get_metadata().number_of_points()


def read_all(path: Union[str, Path],
             schema: Optional[PointSchema] = None) -> HostPointBuffer:
    """Open + read every point (reference base/mod.rs:28-45).

    Example — round-trip a buffer through a LAS file:

    >>> import numpy as np, tempfile, os
    >>> from pasture_tpu_torch.buffers.host import HostPointBuffer
    >>> from pasture_tpu_torch.io import read_all, write_all
    >>> from pasture_tpu_torch.layout import attributes as att
    >>> from pasture_tpu_torch.layout.schema import PointSchema
    >>> schema = PointSchema.from_attributes([att.POSITION_3D,
    ...                                       att.INTENSITY])
    >>> buf = HostPointBuffer.from_columns(schema, {
    ...     att.POSITION_3D.name: np.asarray([[1.0, 2.0, 3.0],
    ...                                       [4.0, 5.0, 6.0]]),
    ...     att.INTENSITY.name: np.asarray([10, 20], np.uint16)})
    >>> path = os.path.join(tempfile.mkdtemp(), "two.las")
    >>> write_all(buf, path)
    >>> back = read_all(path)
    >>> len(back)
    2
    >>> back.get_converted(att.POSITION_3D).tolist()
    [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]
    >>> back.get(att.INTENSITY.name).tolist()
    [10, 20]
    """
    with open_reader(path) as r:
        return r.read_all(schema)


def read_all_into(buffer: HostPointBuffer,
                  path: Union[str, Path]) -> HostPointBuffer:
    """Open + read every point into ``buffer``'s schema and append
    (reference ``read_all_into``, base/mod.rs:48-60).

    .. warning:: Unlike the reference, which mutates the destination in
       place, host buffers here are value-style: the input ``buffer`` is
       NOT modified.  You MUST use the returned buffer —
       ``buf = read_all_into(buf, path)`` — or the appended points are
       silently lost."""
    with open_reader(path) as r:
        return buffer.append(r.read_all(buffer.schema))


#: Preferred, misuse-resistant name for :func:`read_all_into`: the "appended"
#: spelling makes the value-style contract (use the RETURN value) explicit,
#: so callers porting from the reference's in-place ``read_all_into`` don't
#: silently drop the result (advisor finding, round 1).
read_all_appended = read_all_into


def write_all(buffer: HostPointBuffer, path: Union[str, Path], **kw) -> None:
    """Open + write + flush (reference base/mod.rs:63-79); the format is
    chosen by extension (``.las``/``.laz``/``.pnts``).  See
    :func:`read_all` for a round-trip example."""
    with open_writer(path, buffer.schema, **kw) as w:
        w.write(buffer)

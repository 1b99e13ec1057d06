"""tileset.json data model (parity: pasture-io/src/tiles3d/tileset.rs:11-365).

``Tile`` mirrors the reference's recursive ``Tileset`` struct (bounding
volume, geometric error, refine mode, content uri, transform, children);
``Tileset`` mirrors ``RootTileset`` (asset info + root tile);
``TilesetBuilder`` the fluent builder (tileset.rs:175-240).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np

__all__ = [
    "Refinement", "BoundingVolume", "Tile", "Tileset", "TilesetBuilder",
    "read_tileset", "write_tileset",
]


class Refinement(enum.Enum):
    REPLACE = "REPLACE"
    ADD = "ADD"


@dataclasses.dataclass(frozen=True)
class BoundingVolume:
    """One of region (6 f64), box (12 f64), sphere (4 f64)
    (tileset.rs:22-132)."""

    kind: str      # "region" | "box" | "sphere"
    values: tuple

    @staticmethod
    def region(west: float, south: float, east: float, north: float,
               min_height: float, max_height: float) -> "BoundingVolume":
        return BoundingVolume("region",
                              (west, south, east, north, min_height,
                               max_height))

    @staticmethod
    def box(center, x_half, y_half, z_half) -> "BoundingVolume":
        vals = tuple(np.concatenate([
            np.asarray(center, np.float64), np.asarray(x_half, np.float64),
            np.asarray(y_half, np.float64), np.asarray(z_half, np.float64)]))
        return BoundingVolume("box", vals)

    @staticmethod
    def sphere(center, radius: float) -> "BoundingVolume":
        c = np.asarray(center, np.float64)
        return BoundingVolume("sphere", (c[0], c[1], c[2], radius))

    def to_json(self) -> Dict[str, Any]:
        return {self.kind: list(self.values)}

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "BoundingVolume":
        for kind in ("region", "box", "sphere"):
            if kind in obj:
                return cls(kind, tuple(obj[kind]))
        raise ValueError(f"unknown bounding volume {obj!r}")


@dataclasses.dataclass
class Tile:
    """A tile node (reference ``Tileset``, tileset.rs:153-173)."""

    geometric_error: float
    bounding_volume: BoundingVolume
    refine: Optional[Refinement] = None
    viewer_request_volume: Optional[BoundingVolume] = None
    content_uri: Optional[str] = None
    content_bounding_volume: Optional[BoundingVolume] = None
    transform: Optional[np.ndarray] = None   # 4x4, column-major in JSON
    children: List["Tile"] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        obj: Dict[str, Any] = {
            "geometricError": self.geometric_error,
            "boundingVolume": self.bounding_volume.to_json(),
        }
        if self.refine is not None:
            obj["refine"] = self.refine.value
        if self.viewer_request_volume is not None:
            obj["viewerRequestVolume"] = self.viewer_request_volume.to_json()
        if self.content_uri is not None:
            content: Dict[str, Any] = {"uri": self.content_uri}
            if self.content_bounding_volume is not None:
                content["boundingVolume"] = \
                    self.content_bounding_volume.to_json()
            obj["content"] = content
        if self.transform is not None:
            obj["transform"] = list(
                np.asarray(self.transform, np.float64).T.ravel())
        if self.children:
            obj["children"] = [c.to_json() for c in self.children]
        return obj

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "Tile":
        content = obj.get("content") or {}
        transform = obj.get("transform")
        return cls(
            geometric_error=obj["geometricError"],
            bounding_volume=BoundingVolume.from_json(obj["boundingVolume"]),
            refine=Refinement(obj["refine"]) if "refine" in obj else None,
            viewer_request_volume=(
                BoundingVolume.from_json(obj["viewerRequestVolume"])
                if "viewerRequestVolume" in obj else None),
            content_uri=content.get("uri"),
            content_bounding_volume=(
                BoundingVolume.from_json(content["boundingVolume"])
                if "boundingVolume" in content else None),
            transform=(np.asarray(transform, np.float64).reshape(4, 4).T
                       if transform is not None else None),
            children=[cls.from_json(c) for c in obj.get("children", [])],
        )


@dataclasses.dataclass
class Tileset:
    """Root tileset document (reference ``RootTileset``,
    tileset.rs:273-300)."""

    root: Tile
    geometric_error: float
    version: str = "1.0"
    tileset_version: Optional[str] = None
    properties: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        asset: Dict[str, Any] = {"version": self.version}
        if self.tileset_version:
            asset["tilesetVersion"] = self.tileset_version
        obj = {
            "asset": asset,
            "geometricError": self.geometric_error,
            "root": self.root.to_json(),
        }
        if self.properties:
            obj["properties"] = self.properties
        return obj

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "Tileset":
        asset = obj.get("asset", {})
        return cls(
            root=Tile.from_json(obj["root"]),
            geometric_error=obj["geometricError"],
            version=asset.get("version", "1.0"),
            tileset_version=asset.get("tilesetVersion"),
            properties=obj.get("properties", {}),
        )


class TilesetBuilder:
    """Fluent tile builder (reference TilesetBuilder, tileset.rs:175-240)."""

    def __init__(self) -> None:
        self._tile = Tile(geometric_error=0.0,
                          bounding_volume=BoundingVolume.sphere((0, 0, 0), 0))

    def geometric_error(self, e: float) -> "TilesetBuilder":
        self._tile.geometric_error = e
        return self

    def refinement(self, r: Refinement) -> "TilesetBuilder":
        self._tile.refine = r
        return self

    def bounding_volume(self, bv: BoundingVolume) -> "TilesetBuilder":
        self._tile.bounding_volume = bv
        return self

    def viewer_request_volume(self, bv: BoundingVolume) -> "TilesetBuilder":
        self._tile.viewer_request_volume = bv
        return self

    def content(self, uri: str,
                bounding_volume: Optional[BoundingVolume] = None
                ) -> "TilesetBuilder":
        self._tile.content_uri = uri
        self._tile.content_bounding_volume = bounding_volume
        return self

    def transform(self, matrix) -> "TilesetBuilder":
        self._tile.transform = np.asarray(matrix, np.float64).reshape(4, 4)
        return self

    def add_child(self, child: Tile) -> "TilesetBuilder":
        self._tile.children.append(child)
        return self

    def build(self) -> Tile:
        return self._tile


def read_tileset(path: Union[str, Path]) -> Tileset:
    """Load a ``tileset.json`` into a :class:`Tileset` (reference
    tiles3d/tileset.rs)."""
    with open(path) as f:
        return Tileset.from_json(json.load(f))


def write_tileset(tileset: Tileset, path: Union[str, Path]) -> None:
    """Write a :class:`Tileset` as ``tileset.json`` (reference
    tiles3d/tileset.rs)."""
    with open(path, "w") as f:
        json.dump(tileset.to_json(), f)

"""3D Tiles point-cloud format backend (parity: pasture-io/src/tiles3d/)."""

from .feature_table import (  # noqa: F401
    FeatureTableDataReference,
    read_feature_table_header,
    write_feature_table_header,
)
from .pnts import (  # noqa: F401
    PntsMetadata,
    PntsReader,
    PntsReadPositionsMode,
    PntsWriter,
)
from .tileset import (  # noqa: F401
    BoundingVolume,
    Refinement,
    Tile,
    Tileset,
    TilesetBuilder,
    read_tileset,
    write_tileset,
)

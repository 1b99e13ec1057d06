"""LAS/LAZ format backend (parity: pasture-io/src/las/)."""

from .conversion import get_default_las_converter  # noqa: F401
from .header import LasHeader, LasPointFormat, LasVlr  # noqa: F401
from .layout import (  # noqa: F401
    ATTRIBUTE_BASIC_FLAGS,
    ATTRIBUTE_EXTENDED_FLAGS,
    ATTRIBUTE_LOCAL_LAS_POSITION,
    is_known_las_attribute,
    las_format_from_point_schema,
    point_schema_from_las_format,
)
from .metadata import (  # noqa: F401
    ClassificationLookup,
    ExtraBytesEntry,
    ExtraBytesVlr,
    LasMetadata,
    TextAreaDescription,
)
from .reader import LasReader, path_is_compressed_las_file  # noqa: F401
from .writer import LasWriter, default_las_header  # noqa: F401

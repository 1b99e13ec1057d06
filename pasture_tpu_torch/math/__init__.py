"""Math utilities (Morton coding, bounding boxes, min/max semantics)."""

from ..layout.schema import align_to
from .aabb import AABB
from .minmax import infimum, minmax_column, supremum
from .morton import (expand_bits_by_3, morton_decode_u32,
                     morton_encode_dual32, morton_encode_u64, morton_key_f32,
                     reverse_bits)

__all__ = ["expand_bits_by_3", "reverse_bits", "morton_encode_u64",
           "morton_encode_dual32", "morton_decode_u32", "morton_key_f32",
           "AABB", "align_to", "infimum",
           "supremum", "minmax_column"]

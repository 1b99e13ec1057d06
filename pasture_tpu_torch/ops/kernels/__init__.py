"""Hand-written CUDA kernels for the hot per-point stages, each beside its
plain PyTorch version.  Nothing is compiled at import: the sources under
``csrc/`` are built by ``nvcc`` at the first CUDA launch (``_build.py``)."""

from .compact_kernel import blockwise_compact  # noqa: F401
from .fused_transform import (  # noqa: F401
    exact_local_base_coeffs, exact_local_max_leaf,
    fused_decode_transform_key, fused_voxel_head,
    fused_voxel_head_exact_local, fused_world_bounds)
from .icp_step_kernel import (  # noqa: F401
    icp_correspond_accumulate, icp_iterate, icp_solve_update)
from .tile_sort_kernel import supports_tile_sort, tile_sort  # noqa: F401
from .voxel_reduce_kernel import fused_sorted_voxel_reduce  # noqa: F401
from .window_fit_kernel import (  # noqa: F401
    supports_window_fit, window_fit_moments)


def _kernel_modules():
    from . import (compact_kernel, fused_transform, icp_step_kernel,
                   tile_sort_kernel, voxel_reduce_kernel, window_fit_kernel)
    return (compact_kernel, fused_transform, icp_step_kernel,
            tile_sort_kernel, voxel_reduce_kernel, window_fit_kernel)


def launch_counts() -> dict:
    """Launch count of every kernel, by wrapper name."""
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for mod in _kernel_modules():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0

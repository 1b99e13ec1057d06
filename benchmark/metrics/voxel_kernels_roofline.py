"""The voxel step's four hand kernels (K1 world bounds, K2 exact-local
head, K4 tile sort, K3 voxel reduce) against their roofline: the least
time their bytes need at the card's published memory rate, summed over the
traced steps, over the time their launches took in the trace (K3's two
launches both: the reduce and the zeroing of the rows past the count)."""
import roofline


def read(run):
    if run.device_busy_s is None or not run.units \
            or "roofline_bytes" not in run.units[0]:
        return None
    names = roofline.KERNEL_NAMES
    need = sum(roofline.bound_seconds(u["roofline_bytes"][k])
               for u in run.units for k in names)
    parts = [p for ps in names.values() for p in ps]
    took = sum(d for n, _, d in run.kernels
               if any(p in n for p in parts)) / 1e6
    return 100.0 * need / took if took > 0 else None

"""A synthetic AHN4 sub-tile, made on the device from a seed.

The tile is ``size_m`` metres of Dutch lowland seen from the air at
``points_per_m2`` points a square metre, spread evenly: every square metre
gets exactly that many points (a fractional density is drawn per square
metre with the remainder as a probability).  The scene comes from the
seed: gently varying terrain (class 2), canals (class 9), buildings with
flat roofs (class 6) and tree crowns (class 1) over the ground.  Positions
are integer millimetres from the tile's south-west corner: the LAS locals
at a scale of 0.001 m, with the corner's map coordinates as the LAS
offset.

The points come out in Morton order over a quadtree whose cells are powers
of two of 1/1024 m, so every aligned square of ``2**k / 1024`` metres (the
512 m of a 10-bit grid at a 0.5 m leaf among them) is one contiguous run,
as in a survey archive sorted along a space-filling curve.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

#: ASPRS classes the scene uses (AHN4's ground, building, water, vegetation)
GROUND, VEGETATION, BUILDING, WATER = 2, 1, 6, 9


def _spread2(v: torch.Tensor) -> torch.Tensor:
    """The low 21 bits of ``v`` (int64) spread two apart."""
    v = v & 0x1FFFFF
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    v = (v | (v << 1)) & 0x5555555555555555
    return v


def morton2(x_mm: torch.Tensor, y_mm: torch.Tensor) -> torch.Tensor:
    """2-D Morton code of millimetre coordinates on a grid of 1/1024 m."""
    qx = (x_mm.to(torch.int64) * 128) // 125
    qy = (y_mm.to(torch.int64) * 128) // 125
    return _spread2(qx) | (_spread2(qy) << 1)


def _uniform(g, n, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=dev,
                                       dtype=torch.float64)


def _scene(cfg: Dict, g: torch.Generator, dev) -> Dict[str, torch.Tensor]:
    """Rasters of one metre: label (0 ground, 6, 9), building height and
    canopy height above the ground."""
    sx, sy = (int(v) for v in cfg["size_m"])
    area = sx * sy / 1e6                        # km²
    label = torch.zeros((sy, sx), dtype=torch.uint8, device=dev)
    bheight = torch.zeros((sy, sx), dtype=torch.float64, device=dev)
    canopy = torch.zeros((sy, sx), dtype=torch.float64, device=dev)
    s = cfg["scene"]
    # canals: straight bands across the tile, along x or along y
    for _ in range(max(1, round(s["canals_per_km2"] * area))):
        along_x = bool(torch.rand(1, generator=g, device=dev) < 0.5)
        width = int(_uniform(g, 1, *s["canal_width_m"], dev))
        span = sy if along_x else sx
        at = int(_uniform(g, 1, 0, max(span - width, 1), dev))
        if along_x:
            label[at:at + width, :] = WATER
        else:
            label[:, at:at + width] = WATER
    # buildings: axis-aligned footprints with flat roofs, never on water
    nb = round(s["buildings_per_km2"] * area)
    wl = _uniform(g, 2 * nb, *s["building_side_m"], dev).reshape(nb, 2)
    xy = torch.rand((nb, 2), generator=g, device=dev, dtype=torch.float64)
    h = _uniform(g, nb, *s["building_height_m"], dev)
    # the parameters come to the host once: one loop of slices, no reads
    for (w, ln), (fx, fy), hi in zip(wl.long().tolist(), xy.tolist(),
                                     h.tolist()):
        x0 = int(fx * max(sx - w, 1))
        y0 = int(fy * max(sy - ln, 1))
        win = label[y0:y0 + ln, x0:x0 + w]
        dry = win != WATER
        win[dry] = BUILDING
        bheight[y0:y0 + ln, x0:x0 + w][dry] = hi
    # trees: discs of canopy on open ground
    nt = round(s["trees_per_km2"] * area)
    txy = torch.rand((nt, 2), generator=g, device=dev, dtype=torch.float64)
    tr = _uniform(g, nt, *s["crown_radius_m"], dev)
    th = _uniform(g, nt, *s["tree_height_m"], dev)
    for (fx, fy), r, top in zip(txy.tolist(), tr.tolist(), th.tolist()):
        cx, cy = fx * sx, fy * sy
        x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, sx)
        y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, sy)
        if x0 >= x1 or y0 >= y1:
            continue
        yy, xx = torch.meshgrid(
            torch.arange(y0, y1, device=dev, dtype=torch.float64) + 0.5,
            torch.arange(x0, x1, device=dev, dtype=torch.float64) + 0.5,
            indexing="ij")
        inside = ((xx - cx) ** 2 + (yy - cy) ** 2 <= r * r) \
            & (label[y0:y1, x0:x1] == 0)
        c = canopy[y0:y1, x0:x1]
        c[inside] = torch.clamp_min(c[inside], top)
    return {"label": label, "bheight": bheight, "canopy": canopy,
            "phase": torch.rand(4, generator=g, device=dev,
                                dtype=torch.float64) * 2 * math.pi}


def _ground(x: torch.Tensor, y: torch.Tensor, phase, amp: float):
    """Terrain height (m) of the tile: a few long waves of ``amp`` metres."""
    return amp * (0.5 * torch.sin(x / 173.0 + phase[0])
                  + 0.3 * torch.sin(y / 97.0 + phase[1])
                  + 0.2 * torch.sin((x + y) / 41.0 + phase[2]))


def make_tile(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The tile's points on ``device``: ``local`` (n, 3) int32 millimetres,
    ``intensity`` (n,) int32 holding u16 values, ``classification`` (n,)
    uint8, in Morton order.  The same ``seed`` gives the same points on the
    same kind of device."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    sx, sy = (int(v) for v in cfg["size_m"])
    scene = _scene(cfg, g, dev)
    # points per square metre: the whole part everywhere, one more where a
    # draw falls under the fractional part
    dens = float(cfg["points_per_m2"])
    whole, frac = int(dens), dens - int(dens)
    per = torch.full((sy * sx,), whole, dtype=torch.int64, device=dev)
    if frac > 0:
        per += (torch.rand(sy * sx, generator=g, device=dev) < frac).long()
    cell = torch.repeat_interleave(
        torch.arange(sy * sx, device=dev, dtype=torch.int64), per)
    n = cell.shape[0]
    cy, cx = cell // sx, cell % sx
    x_mm = cx * 1000 + torch.randint(0, 1000, (n,), generator=g, device=dev)
    y_mm = cy * 1000 + torch.randint(0, 1000, (n,), generator=g, device=dev)
    x, y = x_mm.double() / 1000.0, y_mm.double() / 1000.0
    s = cfg["scene"]
    ground = _ground(x, y, scene["phase"], s["terrain_amplitude_m"])
    noise = torch.randn(n, generator=g, device=dev, dtype=torch.float64) \
        * s["vertical_noise_m"]
    lab = scene["label"].reshape(-1)[cell]
    z = ground + noise
    cls = torch.full((n,), GROUND, dtype=torch.uint8, device=dev)
    water = lab == WATER
    z = torch.where(water, s["water_level_m"] + noise, z)
    cls[water] = WATER
    bld = lab == BUILDING
    z = torch.where(bld, z + scene["bheight"].reshape(-1)[cell], z)
    cls[bld] = BUILDING
    can = scene["canopy"].reshape(-1)[cell]
    u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    hit = (can > 0) & (u < s["canopy_return_share"])
    z = torch.where(hit, z + can * (0.35 + 0.65 * torch.rand(
        n, generator=g, device=dev, dtype=torch.float64)), z)
    cls[hit] = VEGETATION
    # intensity uniform in the class's [lo, hi) range
    lo = torch.zeros(256, dtype=torch.float64, device=dev)
    hi = torch.ones(256, dtype=torch.float64, device=dev)
    for c, (a, b) in s["intensity"].items():
        lo[int(c)], hi[int(c)] = float(a), float(b)
    ci = cls.long()
    inten = (lo[ci] + torch.rand(n, generator=g, device=dev,
                                 dtype=torch.float64)
             * (hi[ci] - lo[ci])).floor().to(torch.int64)
    z_mm = torch.round(z * 1000.0).to(torch.int64)
    order = torch.sort(morton2(x_mm, y_mm), stable=True).indices
    local = torch.stack([x_mm, y_mm, z_mm], dim=1)[order].to(torch.int32)
    return {"local": local.contiguous(),
            "intensity": inten[order].to(torch.int32),
            "classification": cls[order]}


def block_runs(local: torch.Tensor, block_mm: int):
    """``[(start, count)]`` of the runs of aligned ``block_mm`` squares in
    the tile's Morton order, in that order (each square is one run)."""
    bx = local[:, 0].to(torch.int64) // block_mm
    by = local[:, 1].to(torch.int64) // block_mm
    b = bx * 65536 + by
    change = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    change[1:] = b[1:] != b[:-1]
    starts = torch.nonzero(change)[:, 0].tolist() + [b.shape[0]]
    return [(s, e - s) for s, e in zip(starts[:-1], starts[1:])]

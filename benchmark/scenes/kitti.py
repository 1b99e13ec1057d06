"""Spinning-LiDAR scans of a street canyon, ray-cast on the device.

A vehicle drives a closed lap around one city block: a rounded rectangle
of ``scans * step_m`` metres, counter-clockwise, the sensor
``sensor_height_m`` above the road.  The scene comes from the seed: the
block's buildings and those across the street as boxes in segments of
random length, setback and height (the setbacks give the along-track
structure a scan match needs), parked cars along both kerbs and poles on
the pavements.  The outer corners stay open, as crossing streets.

Each scan casts one ray a beam and azimuth step (``beams`` elevations
evenly from ``elevation_deg[0]`` to ``[1]``, ``azimuths`` a turn) against
the ground plane and every box, keeps the nearest hit within
``max_range_m``, adds Gaussian range noise and returns the points in the
sensor's own frame (x ahead, z up) as float64, as a driver hands them over.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def lap_geometry(cfg: Dict) -> Tuple[float, float, float, float]:
    """``(a, b, r, perimeter)``: the straights' half-lengths along x and y
    and the corner radius of the lap's centre line."""
    lap = cfg["lap"]
    per = lap["scans"] * lap["step_m"]
    r = lap["corner_radius_m"]
    b = (per - 2 * math.pi * r) / (4 * (1 + lap["aspect"]))
    if b <= 0:
        raise ValueError("lap too short for its corner radius")
    return lap["aspect"] * b, b, r, per


def pose_at(s: float, a: float, b: float, r: float) -> Tuple[float, float,
                                                             float]:
    """``(x, y, heading)`` at arc length ``s`` along the centre line,
    starting at (-a, -(b + r)) heading along +x."""
    pieces = [("line", (-a, -(b + r)), 0.0, 2 * a),
              ("arc", (a, -b), -math.pi / 2, math.pi / 2 * r),
              ("line", (a + r, -b), math.pi / 2, 2 * b),
              ("arc", (a, b), 0.0, math.pi / 2 * r),
              ("line", (a, b + r), math.pi, 2 * a),
              ("arc", (-a, b), math.pi / 2, math.pi / 2 * r),
              ("line", (-(a + r), b), -math.pi / 2, 2 * b),
              ("arc", (-a, -b), math.pi, math.pi / 2 * r)]
    total = sum(p[3] for p in pieces)
    s = s % total
    for kind, (x0, y0), ang, length in pieces:
        if s <= length:
            if kind == "line":
                return (x0 + s * math.cos(ang), y0 + s * math.sin(ang), ang)
            phi = ang + s / r
            return (x0 + r * math.cos(phi), y0 + r * math.sin(phi),
                    phi + math.pi / 2)
        s -= length
    raise AssertionError("unreachable")


def _segments(g, dev, length: float, lo: float, hi: float) -> List[float]:
    """Cut points of ``[0, length]`` into pieces of ``lo`` to ``hi``."""
    cuts, at = [0.0], 0.0
    draws = (lo + (hi - lo) * torch.rand(int(length / lo) + 2, generator=g,
                                         device=dev)).tolist()
    for d in draws:
        at += d
        if at >= length:
            break
        cuts.append(at)
    return cuts + [length]


def scene_boxes(cfg: Dict, g: torch.Generator, dev) -> torch.Tensor:
    """(k, 6) float64 boxes ``(xmin, ymin, zmin, xmax, ymax, zmax)``."""
    a, b, r, _ = lap_geometry(cfg)
    sc = cfg["scene"]
    half = sc["street_half_width_m"]
    depth = sc["building_depth_m"]
    boxes = []

    def rand(n, lo, hi):
        return (lo + (hi - lo) * torch.rand(n, generator=g, device=dev,
                                            dtype=torch.float64)).tolist()

    # façades along the four sides: (axis along, fixed coordinate of the
    # centre line, span along, direction into the inner block)
    ex, ey = a + r, b + r
    sides = [("x", -ey, (-ex + half, ex - half), +1),
             ("x", ey, (-ex + half, ex - half), -1),
             ("y", -ex, (-ey + half, ey - half), +1),
             ("y", ex, (-ey + half, ey - half), -1)]
    for axis, c, (s0, s1), inward in sides:
        for face_sign, span in ((inward, (s0, s1)),
                                (-inward, (-(a if axis == "x" else b),
                                           a if axis == "x" else b))):
            cuts = _segments(g, dev, span[1] - span[0],
                             *sc["segment_length_m"])
            n = len(cuts) - 1
            setback = rand(n, *sc["setback_m"])
            height = rand(n, *sc["building_height_m"])
            for i in range(n):
                u0, u1 = span[0] + cuts[i], span[0] + cuts[i + 1]
                face = c + face_sign * (half + setback[i])
                back = face + face_sign * depth
                v0, v1 = min(face, back), max(face, back)
                box = (u0, v0, 0.0, u1, v1, height[i]) if axis == "x" \
                    else (v0, u0, 0.0, v1, u1, height[i])
                boxes.append(box)
    # parked cars along both kerbs of the straights, poles on the pavements
    car_l, car_w, car_h = sc["car_size_m"]
    for axis, c, _, inward in sides:
        span = a if axis == "x" else b
        for side in (-1, 1):
            slots = int(2 * span // sc["car_slot_m"])
            occupied = rand(slots, 0.0, 1.0)
            for i in range(slots):
                if occupied[i] >= sc["car_share"]:
                    continue
                u0 = -span + i * sc["car_slot_m"] + 0.5
                v = c + side * sc["kerb_offset_m"]
                box = (u0, v - car_w / 2, 0.0, u0 + car_l, v + car_w / 2,
                       car_h) if axis == "x" else \
                    (v - car_w / 2, u0, 0.0, v + car_w / 2, u0 + car_l, car_h)
                boxes.append(box)
            gaps = rand(int(2 * span // sc["pole_spacing_m"][0]) + 1,
                        *sc["pole_spacing_m"])
            u = -span
            for d in gaps:
                u += d
                if u > span:
                    break
                v = c + side * sc["pole_offset_m"]
                w = sc["pole_width_m"] / 2
                box = (u - w, v - w, 0.0, u + w, v + w, sc["pole_height_m"]) \
                    if axis == "x" else \
                    (v - w, u - w, 0.0, v + w, u + w, sc["pole_height_m"])
                boxes.append(box)
    return torch.tensor(boxes, dtype=torch.float64, device=dev)


def _cast(origin: torch.Tensor, dirs: torch.Tensor, boxes: torch.Tensor,
          max_range: float, block: int = 32) -> torch.Tensor:
    """Nearest hit distance of each ray (inf where none within range)."""
    best = torch.full((dirs.shape[0],), math.inf, dtype=dirs.dtype,
                      device=dirs.device)
    down = dirs[:, 2] < 0
    tg = -origin[2] / torch.where(down, dirs[:, 2], -torch.ones_like(best))
    best = torch.where(down, tg, best)
    inv = 1.0 / torch.where(dirs == 0, torch.full_like(dirs, 1e-30), dirs)
    for i in range(0, boxes.shape[0], block):
        bx = boxes[i:i + block]
        t0 = (bx[None, :, :3] - origin) * inv[:, None, :]
        t1 = (bx[None, :, 3:] - origin) * inv[:, None, :]
        near = torch.minimum(t0, t1).amax(dim=2)
        far = torch.maximum(t0, t1).amin(dim=2)
        hit = (near <= far) & (near > 0)
        t = torch.where(hit, near, torch.full_like(near, math.inf)).amin(1)
        best = torch.minimum(best, t)
    return torch.where(best <= max_range, best,
                       torch.full_like(best, math.inf))


def make_scans(cfg: Dict, seed: int, device, count=None
               ) -> List[np.ndarray]:
    """The lap's first ``count`` scans (every scan when ``None``), each
    (n_i, 3) float64 in its sensor's frame.  The same ``seed`` gives the
    same scans on the same kind of device."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    boxes = scene_boxes(cfg, g, dev)
    a, b, r, _ = lap_geometry(cfg)
    sen = cfg["sensor"]
    el = torch.deg2rad(torch.linspace(sen["elevation_deg"][0],
                                      sen["elevation_deg"][1], sen["beams"],
                                      dtype=torch.float64, device=dev))
    az = torch.arange(sen["azimuths"], dtype=torch.float64,
                      device=dev) * (2 * math.pi / sen["azimuths"])
    el, az = torch.meshgrid(el, az, indexing="ij")
    el, az = el.reshape(-1), az.reshape(-1)
    local_dirs = torch.stack([torch.cos(el) * torch.cos(az),
                              torch.cos(el) * torch.sin(az),
                              torch.sin(el)], dim=1)
    scans = []
    for i in range(cfg["lap"]["scans"] if count is None else count):
        x, y, h = pose_at(i * cfg["lap"]["step_m"], a, b, r)
        c, s = math.cos(h), math.sin(h)
        rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                           dtype=torch.float64, device=dev)
        origin = torch.tensor([x, y, sen["height_m"]], dtype=torch.float64,
                              device=dev)
        dirs = local_dirs @ rot.T
        t = _cast(origin, dirs, boxes, sen["max_range_m"])
        noise = torch.randn(t.shape[0], generator=g, device=dev,
                            dtype=torch.float64) * sen["range_noise_m"]
        keep = torch.isfinite(t)
        pts = local_dirs[keep] * (t[keep] + noise[keep])[:, None]
        scans.append(pts.cpu().numpy())
    return scans


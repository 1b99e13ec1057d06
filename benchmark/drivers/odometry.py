"""Driver: scans registered one by one by ``RegistrationPipeline``.

Set-up ray-casts the lap's scans on the card from the seed and hands the
first ``warm_scans`` of them to the pipeline (every kernel and library
handle warmed; the pipeline then holds a keyframe).  One unit is one
``add_scan`` of the next scan of the lap, around and around; the pipeline
is the one object set-up built.  Each unit's record notes which keyframe
the scan was aligned to and whether it became one, so the check can work
each answer out again from the raw scans.
"""

from __future__ import annotations

import random
import time

import torch

from reference import compare
from reference import odometry as ref
from scenes import kitti


class Driver:
    def __init__(self, config, traffic, seed, device, workdir):
        from pasture_tpu_torch.pipeline import RegistrationPipeline

        self.device = torch.device(device)
        self.config, self.traffic, self.seed = config, traffic, seed
        t0 = time.perf_counter()
        self.scans = kitti.make_scans(config, seed, self.device)
        t1 = time.perf_counter()
        p = config["pipeline"]
        self.pipe = RegistrationPipeline(
            voxel_size=p["voxel_size"],
            max_correspondence_distance=p["max_correspondence_distance"],
            icp_iterations=p["icp_iterations"],
            keyframe_distance=p["keyframe_distance"],
            point_to_plane=p["point_to_plane"], device=self.device)
        self.kf_scan = []          # lap index of each keyframe
        self.records = []          # (scan, target keyframe, new keyframe)
        self.next = 0
        for _ in range(traffic["warm_scans"]):
            self._add()
        self.records = []
        self.phases = {"generate_s": t1 - t0,
                       "warm_s": time.perf_counter() - t1}

    def _add(self):
        j = self.next % len(self.scans)
        self.next += 1
        before = len(self.pipe.keyframes)
        self.pipe.add_scan(self.scans[j])
        made = len(self.pipe.keyframes) > before
        if made:
            self.kf_scan.append(j)
        self.records.append((j, before - 1, before if made else None))
        return j

    def unit(self, i):
        j = self._add()
        return {"scans": 1, "points": len(self.scans[j])}

    def counters(self):
        return {}

    def info(self):
        return {"setup_phases": self.phases}

    def release(self):
        pass

    def _sampled(self):
        """Window scans to check: ``checked_units`` drawn from the seed,
        and the one with the most points."""
        recs = [r for r in self.records if r[1] >= 0]
        rng = random.Random(self.seed)
        k = min(self.traffic["checked_units"], len(recs))
        picked = rng.sample(range(len(recs)), k)
        biggest = max(range(len(recs)),
                      key=lambda i: len(self.scans[recs[i][0]]))
        return [recs[i] for i in sorted(set(picked) | {biggest})]

    def _keyframe_map(self, points, anchor_of):
        """A keyframe's points as codes of the reference's cells."""
        pts = torch.as_tensor(points, dtype=torch.float64,
                              device=self.device)
        cells = ref.voxel_cells(pts, anchor_of, self.config["pipeline"][
            "voxel_size"])
        code = ref.cell_code(cells)
        order = torch.argsort(code)
        return code[order], pts[order]

    def check(self, control):
        p = self.config["pipeline"]
        voxel = p["voxel_size"]
        kf = self.pipe.keyframes
        readings = []
        if control:
            # the lap's first scans, each against the one before
            recs = [(j, None, None) for j in
                    range(1, self.traffic["checked_units"] + 2)]
        else:
            recs = self._sampled()
        for j, kt, ks in recs:
            jt = j - 1 if control else self.kf_scan[kt]
            src = torch.as_tensor(self.scans[j], device=self.device)
            tgt = torch.as_tensor(self.scans[jt], device=self.device)
            c_src, p_src = ref.downsample(src, voxel)
            c_tgt, p_tgt = ref.downsample(tgt, voxel)
            r_ref, t_ref = ref.icp(p_src, p_tgt, p["icp_iterations"],
                                   p["max_correspondence_distance"])
            r = {"keyframe_voxels_unmatched": 0.0,
                 "keyframe_centroid_gap_m": 0.0}
            if control:
                r_got, t_got = ref.icp(p_src, p_tgt, p["icp_iterations"],
                                       p["max_correspondence_distance"],
                                       precision="tf32")
                made = ref.spawns_keyframe(r_got, t_got,
                                           p["keyframe_distance"])
                code, got = ref.downsample(src, voxel, "bfloat16")
                r.update(_keyframe_gaps(code, got, c_src, p_src))
            else:
                # the keyframe the scan was aligned to, as the program held
                # it, and the one it made
                for k, pts, cells in ((kt, p_tgt, c_tgt), (ks, p_src, c_src)):
                    if k is None:
                        continue
                    anchor = tgt.min(0).values if k == kt \
                        else src.min(0).values
                    code, got = self._keyframe_map(kf[k].points, anchor)
                    for name, v in _keyframe_gaps(code, got, cells,
                                                  pts).items():
                        r[name] = max(r[name], v)
                made = ks is not None
                if made:
                    r0 = torch.as_tensor(kf[kt].rotation, device=self.device)
                    t0 = torch.as_tensor(kf[kt].translation,
                                         device=self.device)
                    r1 = torch.as_tensor(kf[ks].rotation, device=self.device)
                    t1 = torch.as_tensor(kf[ks].translation,
                                         device=self.device)
                    r_got, t_got = r0.T @ r1, r0.T @ (t1 - t0)
            want = ref.spawns_keyframe(r_ref, t_ref, p["keyframe_distance"])
            r["keyframe_decision_mismatch"] = float(made != want)
            if made:
                r["pose_gap_m"] = float((t_got - t_ref).abs().max())
                # the angle between the rotations: |R1 - R2|_F is
                # 2 sqrt(2) sin(angle / 2), and keeps its digits near 0
                chord = torch.linalg.norm(r_got - r_ref) / (2 * 2 ** 0.5)
                r["pose_gap_deg"] = float(torch.rad2deg(
                    2 * torch.arcsin(chord.clamp(max=1.0))))
            else:
                r["pose_gap_m"] = r["pose_gap_deg"] = 0.0
            readings.append(r)
        return compare.worst(readings, self.traffic["limits"])

    def close(self):
        self.scans = None


def _keyframe_gaps(code, got, ref_code, ref_pts):
    """Voxels in one keyframe and not the other, and the widest centroid
    gap (metres) among those in both."""
    m = compare.keyed({"key": code, "centroid": got},
                      {"key": ref_code, "centroid": ref_pts})
    return {"keyframe_voxels_unmatched": m["voxels_unmatched"],
            "keyframe_centroid_gap_m": m["centroid_gap_m"]}

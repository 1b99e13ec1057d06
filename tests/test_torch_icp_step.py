"""K8, the fused exact-correspondence ICP iteration: its plain version (what
a CPU tensor runs, ``icp``'s float32 exact path included, and what the CUDA
kernels equal bit for bit on the card) against the port's eager ``icp``
loop (float64) on random clouds and on a street canyon; the first-index tie rule, invalid rows and zero inliers; a model of
the kernels' schedule (lanes over interleaved target rows, the warp's
butterfly merge, 8-query partials, K8b's lane sums) against the plain
version, bit for bit; and, on the card only, the kernels against the plain
version.  Imports nothing of JAX."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pasture_tpu_torch._device import fp32_matmul
from pasture_tpu_torch.ops import kernels
from pasture_tpu_torch.ops.kernels import icp_step_kernel as ks
from pasture_tpu_torch.registration import icp
from pasture_tpu_torch.registration.icp import _nearest, _normals_device

EPS32 = 2.0 ** -24
IDENTITY = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]


def _yaw(angle):
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _surface_pair(rng, n=1500):
    """A smooth random surface and its view under a small turn and shift."""
    u = rng.uniform(-3.0, 3.0, (n, 2))
    z = 0.3 * np.sin(u[:, 0] * 2.0) + 0.2 * np.cos(u[:, 1] * 1.5)
    tgt = np.stack([u[:, 0], u[:, 1], z], axis=1)
    src = tgt @ _yaw(0.03).T + np.array([0.1, -0.08, 0.05])
    return src.astype(np.float32), tgt.astype(np.float32)


def _canyon_scan(rng, n, x0):
    """``n`` points on the surfaces of a 48 m street canyon seen from
    ``x0`` along it: ground, façades in 4 m segments set back 0–3 m, parked
    cars and poles, 2 cm of noise (a 1 m voxel keyframe's density)."""
    k = rng.multinomial(n, [0.35, 0.45, 0.12, 0.08])
    ground = np.stack([rng.uniform(0, 48, k[0]), rng.uniform(-8, 8, k[0]),
                       np.zeros(k[0])], axis=1)
    fx = rng.uniform(0, 48, k[1])
    side = np.where(rng.random(k[1]) < 0.5, -1.0, 1.0)
    setback = np.array([0.0, 1.5, 3.0, 0.5, 2.0, 1.0])[
        (fx // 4).astype(int) % 6]
    facade = np.stack([fx, side * (8.0 + setback),
                       rng.uniform(0, 12, k[1])], axis=1)
    slot = rng.integers(0, 8, k[2])
    cars = np.stack([slot * 6.0 + rng.uniform(0, 4.2, k[2]),
                     np.where(slot % 2, 5.0, -5.0) + rng.uniform(-0.9, 0.9,
                                                                 k[2]),
                     np.full(k[2], 1.5)], axis=1)
    pole = rng.integers(0, 6, k[3])
    a = rng.uniform(0, 2 * np.pi, k[3])
    poles = np.stack([pole * 8.0 + 0.15 * np.cos(a),
                      np.where(pole % 2, 6.8, -6.8) + 0.15 * np.sin(a),
                      rng.uniform(0, 6, k[3])], axis=1)
    pts = np.concatenate([ground, facade, cars, poles])
    pts = pts + rng.normal(0, 0.02, pts.shape)
    return pts - np.array([x0, 0.0, 0.0])


def _canyon_pair(rng, n=2400):
    """Two scans 0.7 m apart, each sampled anew, relative to the target's
    minimum as ``RegistrationPipeline`` hands them to ``icp``."""
    tgt = _canyon_scan(rng, n, 0.0)
    src = _canyon_scan(rng, n, 0.7)
    lo = tgt.min(axis=0)
    return (src - lo).astype(np.float32), (tgt - lo).astype(np.float32)


def _normals(target, valid=None):
    valid = torch.ones(target.shape[0], dtype=torch.bool) if valid is None \
        else valid
    with fp32_matmul():
        nrm, _ = _normals_device(target, valid, 16, 2048)
    return nrm.contiguous()


def _run_plain(src, tgt, point_to_plane, iterations=20, sv=None, tv=None,
               max_dist=1.0, pose=None):
    """The plain version's loop; returns (pose (12,), rmse, num_inliers)."""
    sv = torch.ones(src.shape[0], dtype=torch.bool) if sv is None else sv
    tv = torch.ones(tgt.shape[0], dtype=torch.bool) if tv is None else tv
    nrm = _normals(tgt, tv) if point_to_plane else None
    pose = torch.tensor(IDENTITY if pose is None else pose,
                        dtype=torch.float32)
    rmse, nin = ks.icp_iterate(src, sv, tgt, tv, nrm, pose, max_dist ** 2,
                               point_to_plane, 1e-6, iterations)
    return pose, rmse, nin


def _pose_gap(pose, result):
    """(metres, radians) between a (12,) pose and an ``IcpResult``."""
    rot = pose[:9].view(3, 3).double()
    dt = (pose[9:].double() - result.translation.double()).abs().max()
    chord = torch.linalg.norm(rot - result.rotation.double()) / math.sqrt(8)
    return float(dt), float(2 * torch.arcsin(chord.clamp(max=1.0)))


@pytest.mark.parametrize("scene", ["random", "canyon"])
@pytest.mark.parametrize("point_to_plane", [False, True])
def test_plain_matches_eager_icp(rng, scene, point_to_plane):
    """20 iterations of the plain version against the eager loop (which
    ``icp`` runs on float64): the final pose within 1e-5 m and 1e-5 rad of
    the loop's, the same inliers, the motion recovered; and ``icp`` on the
    float32 CPU tensors runs the plain version, equal to it bit for bit.
    (The plain version sums in float64: float32 sums of the normal
    equations, 50 m from the origin in the canyon, would move the
    point-to-point pose by up to 8 mm.)"""
    src, tgt = (_surface_pair(rng) if scene == "random"
                else _canyon_pair(rng))
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    pose, rmse, nin = _run_plain(s, t, point_to_plane)
    want = icp(s.double(), t.double(), point_to_plane=point_to_plane,
               iterations=20)
    gap_m, gap_rad = _pose_gap(pose, want)
    assert gap_m < 1e-5 and gap_rad < 1e-5
    assert int(nin) == int(want.num_inliers) > 0.9 * len(src)
    assert abs(float(rmse) - float(want.rmse)) \
        <= 1e-5 * float(want.rmse) + 1e-6
    got = icp(s, t, point_to_plane=point_to_plane, iterations=20)
    assert torch.equal(torch.cat([got.rotation.reshape(9), got.translation]),
                       pose)
    assert torch.equal(got.rmse, rmse) and int(got.num_inliers) == int(nin)
    if scene == "canyon" and point_to_plane:
        assert abs(float(pose[9]) - 0.7) < 0.05     # the 0.7 m step


@pytest.mark.parametrize("scene", ["random", "canyon"])
def test_nearest_matches_eager_where_apart(rng, scene):
    """The direct distances pick the eager loop's index wherever the two
    nearest targets lie further apart than the eager ``|q|² + |p|² -
    2 q·p``'s float32 rounding can reach; their squared distances agree
    to that rounding."""
    src, tgt = (_surface_pair(rng) if scene == "random"
                else _canyon_pair(rng))
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    tv = torch.ones(t.shape[0], dtype=torch.bool)
    idx, d2 = ks.nearest_direct(s, t, tv)
    with fp32_matmul():
        eidx, ed2 = _nearest(s, t, tv, 2048)
    d64 = torch.cdist(s.double(), t.double()) ** 2
    two = torch.topk(d64, 2, dim=1, largest=False).values
    scale = (s.double() ** 2).sum(1) + (t.double() ** 2).sum(1).max()
    apart = (two[:, 1] - two[:, 0]) > 16 * EPS32 * scale
    assert apart.float().mean() > 0.9
    assert torch.equal(idx[apart], eidx[apart])
    assert torch.equal(idx[apart], torch.argmin(d64, dim=1)[apart])
    assert ((d2.double() - ed2.double()).abs() <= 16 * EPS32 * scale).all()
    assert (d2 >= 0).all()


def test_first_index_wins_a_tie(rng):
    """Duplicated target rows: the first copy is matched, by the plain
    version and by the kernel's schedule."""
    base = rng.uniform(0, 5, (300, 3)).astype(np.float32)
    tgt = np.concatenate([base, base[::-1], base])      # three copies
    t = torch.from_numpy(tgt)
    s = torch.from_numpy(base + np.float32(0.01))
    tv = torch.ones(t.shape[0], dtype=torch.bool)
    idx, _ = ks.nearest_direct(s, t, tv)
    first = torch.arange(300)
    d = torch.cdist(s.double(), torch.from_numpy(base).double())
    own = torch.argmin(d, dim=1)
    assert torch.equal(idx, own)
    midx, _ = _model_nearest(s, t, tv)
    assert torch.equal(midx, own)
    assert torch.equal(torch.sort(own).values, first)


def test_invalid_rows(rng):
    """Invalid target rows are never matched; invalid source rows add
    nothing: the pose equals the eager loop's (float64) with the same
    masks, the inliers count valid rows only."""
    src, tgt = _canyon_pair(rng)
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    sv = torch.from_numpy(rng.random(len(src)) > 0.2)
    tv = torch.from_numpy(rng.random(len(tgt)) > 0.3)
    # an invalid target row exactly under a source row
    t[~tv] = s[:int((~tv).sum())]
    idx, _ = ks.nearest_direct(s, t, tv)
    assert tv[idx].all()
    for ptp in (False, True):
        want = icp(s.double(), t.double(), source_valid=sv, target_valid=tv,
                   point_to_plane=ptp, iterations=20)
        pose, rmse, nin = _run_plain(s, t, ptp, sv=sv, tv=tv)
        gap_m, gap_rad = _pose_gap(pose, want)
        assert gap_m < 1e-5 and gap_rad < 1e-5
        assert int(nin) == int(want.num_inliers) <= int(sv.sum())


def test_zero_inliers_keep_the_pose():
    """No correspondence within the distance: no inlier, a finite rmse of
    0, and the pose left where it started."""
    g = torch.Generator().manual_seed(3)
    t = torch.rand((500, 3), generator=g) * 5
    s = t + torch.tensor([50.0, 0.0, 0.0])
    start = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.5, -0.25, 2.0]
    for ptp in (False, True):
        pose, rmse, nin = _run_plain(s, t, ptp, iterations=3, pose=start)
        assert int(nin) == 0
        assert float(rmse) == 0.0
        assert pose.tolist() == start


def test_series_coefficients_match_the_kernel():
    """The kernel's hex literals are the plain version's doubles; the
    series agree with sin and cos to double rounding up to θ = 2."""
    src = (Path(ks.__file__).parent / "csrc" / "icp_step.cu").read_text()
    for name, coef in (("IS_A", ks.SERIES_A), ("IS_B", ks.SERIES_B),
                       ("IS_C", ks.SERIES_C)):
        body = re.search(name + r"\[IS_SERIES\] = \{(.*?)\};", src,
                         re.S).group(1)
        lits = [float.fromhex(x) for x in body.replace("\n", " ").split(",")]
        assert lits == list(coef)
    assert f"#define IS_SERIES {ks.SERIES}" in src
    for th in (1e-9, 1e-4, 0.1, 0.7, 1.3, 1.999):
        x = th * th
        assert abs(ks._series(ks.SERIES_A, x) - math.sin(th) / th) < 1e-15
        assert abs(ks._series(ks.SERIES_B, x)
                   - 2 * math.sin(th / 2) ** 2 / x) < 1e-15
        want_c = (th - math.sin(th)) / (x * th) if th >= 0.1 \
            else 1.0 / 6.0 - x / 120.0
        assert abs(ks._series(ks.SERIES_C, x) - want_c) < 1e-13


def test_solve_pose_is_the_gauss_newton_step(rng):
    """K8b's host arithmetic against torch's float64 solve and the port's
    se3_exp, on both branches (a small step and one past 2 rad)."""
    from pasture_tpu_torch.registration.se3 import se3_exp
    a = rng.normal(size=(6, 6))
    h = a @ a.T + 6 * np.eye(6)
    for x_true in (rng.normal(size=6) * 0.01,
                   np.array([0.3, -0.2, 0.1, 1.5, -1.2, 1.0])):
        b = h @ x_true          # the step is -solve(H, b) = -x_true
        h_d = h - 1e-6 * np.eye(6)
        sums = [h_d[i, j] for i in range(6) for j in range(i, 6)]
        sums += list(b) + [7.0, 28.0]
        new, rmse, nin = ks.solve_pose(sums, IDENTITY, 1e-6)
        rot, t = se3_exp(torch.from_numpy(-x_true))
        np.testing.assert_allclose(np.reshape(new[:9], (3, 3)), rot.numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(new[9:], t.numpy(), atol=1e-12)
        assert rmse == 2.0 and nin == 7


# ---- a model of the kernels' schedule ---------------------------------------

def _model_nearest(moved, target, target_valid):
    """K8a's correspondence as the lanes of a warp compute it: lane l scans
    target rows l, l + 32, ... (2048-row tiles start at multiples of 32,
    so the interleave runs across them) in ascending order with a strict
    <, then the five xor shuffles keep the smaller (d2, index)."""
    n, m = moved.shape[0], target.shape[0]
    tgt = torch.where(target_valid[:, None], target,
                      torch.tensor(float("inf")))
    rows = -(-m // 32)
    bd = torch.full((n, 32), float("inf"))
    bj = torch.full((n, 32), 2 ** 31 - 1, dtype=torch.int64)
    for r in range(rows):
        for lane in range(32):
            j = 32 * r + lane
            if j >= m:
                continue
            dx = tgt[j, 0] - moved[:, 0]
            dy = tgt[j, 1] - moved[:, 1]
            dz = tgt[j, 2] - moved[:, 2]
            d = dx * dx + dy * dy + dz * dz
            better = d < bd[:, lane]
            bd[:, lane] = torch.where(better, d, bd[:, lane])
            bj[:, lane] = torch.where(better, j, bj[:, lane])
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        od, oj = bd[:, lanes ^ o], bj[:, lanes ^ o]
        take = (od < bd) | ((od == bd) & (oj < bj))
        bd, bj = torch.where(take, od, bd), torch.where(take, oj, bj)
    return bj[:, 0], bd[:, 0]


def _model_partials(terms, qpw):
    """K8a's partials as its blocks write them: block b's warp w holds
    queries b * 8 qpw + w qpw + q in shared-memory row w qpw + q; thread
    (g, c) sums rows 8g..8g+7 of column c into partial b qpw + g."""
    n = terms.shape[0]
    per = ks.WARPS * qpw
    blocks = -(-n // per)
    out = torch.zeros((ks.TERMS, blocks * qpw), dtype=torch.float64)
    for b in range(blocks):
        smem = torch.zeros((per, ks.TERMS), dtype=torch.float64)
        for w in range(ks.WARPS):
            for q in range(qpw):
                i = b * per + w * qpw + q
                if i < n:
                    smem[w * qpw + q] = terms[i]
        for g in range(qpw):
            acc = torch.zeros(ks.TERMS, dtype=torch.float64)
            for k in range(ks.SUMQ):
                acc = acc + smem[g * ks.SUMQ + k]
            out[:, b * qpw + g] = acc
    return out


def _model_sums(partial):
    """K8b: warp w takes columns w, w + 8, ...; lane l adds partials l,
    l + 32, ... from +0.0; s = s + shfl_xor(s, o) for o = 16 .. 1, lane 0's
    value kept."""
    parts = partial.shape[1]
    sums = []
    for c in range(ks.TERMS):
        lane_sum = []
        for lane in range(32):
            s = torch.zeros((), dtype=torch.float64)
            for p in range(lane, parts, 32):
                s = s + partial[c, p]
            lane_sum.append(s)
        lanes = torch.stack(lane_sum)
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[torch.arange(32) ^ o]
        sums.append(float(lanes[0]))
    return sums


@pytest.mark.parametrize("qpw", ks.QPW)
@pytest.mark.parametrize("point_to_plane", [False, True])
def test_kernel_schedule_model_equals_plain_bitwise(rng, qpw,
                                                    point_to_plane):
    """The identities the kernels' bit equality rests on, on 301 queries
    (not a multiple of any block) against 2 600 targets (two tiles) with
    duplicated and invalid rows: the lexicographic (d2, index) minimum of
    the interleaved lanes is argmin's first index; the blocks' partials
    and K8b's lane sums equal the plain version's padded, reshaped sums."""
    tgt = rng.uniform(0, 6, (2600, 3)).astype(np.float32)
    tgt[1300:1500] = tgt[100:300]                         # ties
    src = (tgt[rng.integers(0, 2600, 301)]
           + rng.normal(0, 0.05, (301, 3))).astype(np.float32)
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    sv = torch.from_numpy(rng.random(301) > 0.1)
    tv = torch.from_numpy(rng.random(2600) > 0.1)
    nrm = _normals(t, tv)
    pose = torch.tensor([0.9998, -0.0175, 0.0, 0.0175, 0.9998, 0.0,
                         0.0, 0.0, 1.0, 0.02, -0.01, 0.03])
    moved = ks._moved_plain(s, pose)
    idx, d2 = ks.nearest_direct(moved, t, tv)
    midx, md2 = _model_nearest(moved, t, tv)
    found = torch.isfinite(d2)
    assert torch.equal(idx[found], midx[found])
    assert torch.equal(d2.view(torch.int32), md2.view(torch.int32))
    terms = ks._query_terms(moved, sv, idx, d2, t, nrm, 0.25, point_to_plane)
    want = ks.icp_correspond_accumulate_plain(s, sv, t, tv, nrm, pose, 0.25,
                                              point_to_plane, qpw)
    got = _model_partials(terms, qpw)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert ks._column_sums(want) == _model_sums(want)
    assert want[27].sum() > 100                          # inliers occur


def test_wrapper_contract_on_the_cpu():
    """CPU tensors run the plain version and count no launch, also through
    ``icp``."""
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(1)
    t = torch.rand((200, 3), generator=g)
    s = t + 0.01
    _run_plain(s, t, True, iterations=2)
    icp(s, t, iterations=2)
    counts = kernels.launch_counts()
    assert counts["icp_correspond_accumulate"] == 0
    assert counts["icp_solve_update"] == 0
    assert ks.partial_count(2400, 1) == 300
    assert ks.partial_count(2401, 1) == 301
    assert ks.partial_count(1 << 20, 8) == (1 << 20) // 8
    with pytest.raises(ValueError):
        ks.icp_iterate(s, torch.ones(200, dtype=torch.bool), t,
                       torch.ones(200, dtype=torch.bool), None,
                       torch.zeros(12), 1.0, False, 1e-6, -1)


# ---- on the card ------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K8 kernels run on the card only")


@pytest.mark.card
@pytest.mark.parametrize("point_to_plane", [False, True])
def test_kernels_equal_plain_on_the_card(point_to_plane):
    """K8a's partials and, after 20 iterations, the pose, rmse and inliers
    of K8 equal the plain version's on the card bit for bit (the steps are
    far below 2 rad)."""
    _need_card()
    rng = np.random.default_rng(7)
    src, tgt = _canyon_pair(rng)
    dev = torch.device("cuda")
    s, t = torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev)
    sv = torch.ones(len(src), dtype=torch.bool, device=dev)
    tv = torch.ones(len(tgt), dtype=torch.bool, device=dev)
    sv[::17] = False
    tv[::13] = False
    with fp32_matmul():
        nrm, _ = _normals_device(t, tv, 16, 2048)
    nrm = nrm.contiguous() if point_to_plane else None
    pose = torch.tensor(IDENTITY, dtype=torch.float32, device=dev)
    for qpw in ks.QPW:
        got = ks.icp_correspond_accumulate(s, sv, t, tv, nrm, pose, 1.0,
                                           point_to_plane, qpw)
        want = ks.icp_correspond_accumulate_plain(s, sv, t, tv, nrm, pose,
                                                  1.0, point_to_plane, qpw)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    kpose, ppose = pose.clone(), pose.clone()
    before = kernels.launch_counts()["icp_correspond_accumulate"]
    krmse, knin = ks.icp_iterate(s, sv, t, tv, nrm, kpose, 1.0,
                                 point_to_plane, 1e-6, 20)
    assert kernels.launch_counts()["icp_correspond_accumulate"] \
        == before + 20
    prmse, pnin = None, None
    for _ in range(20):
        partial = ks.icp_correspond_accumulate_plain(
            s, sv, t, tv, nrm, ppose, 1.0, point_to_plane)
        prmse, pnin = ks.icp_solve_update_plain(partial, ppose, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(kpose.view(torch.int32), ppose.view(torch.int32))
    assert torch.equal(krmse.view(torch.int32), prmse.view(torch.int32))
    assert int(knin) == int(pnin) > 0


@pytest.mark.card
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("point_to_plane", [False, True])
def test_icp_runs_k8_on_the_card(point_to_plane, init):
    """``icp`` itself on float32 CUDA tensors, from the identity and from
    an initial pose: 20 launches of each kernel, and its rotation,
    translation, rmse and inliers equal the plain loop's on the same
    inputs (the target normals ``icp`` fits itself) bit for bit."""
    _need_card()
    rng = np.random.default_rng(11)
    src, tgt = _canyon_pair(rng)
    dev = torch.device("cuda")
    s, t = torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev)
    sv = torch.ones(len(src), dtype=torch.bool, device=dev)
    tv = torch.ones(len(tgt), dtype=torch.bool, device=dev)
    sv[::17] = False
    tv[::13] = False
    kw, start = {}, IDENTITY
    if init:
        rot = torch.from_numpy(_yaw(0.01)).float().to(dev)
        tr = torch.tensor([0.5, 0.02, -0.01], device=dev)
        kw = dict(init_rotation=rot, init_translation=tr)
        start = rot.reshape(9).tolist() + tr.tolist()
    before = kernels.launch_counts()
    got = icp(s, t, source_valid=sv, target_valid=tv,
              point_to_plane=point_to_plane, iterations=20, **kw)
    after = kernels.launch_counts()
    for name in ks.LAUNCHES:
        assert after[name] - before[name] == 20
    nrm = None
    if point_to_plane:
        with fp32_matmul():
            nrm, _ = _normals_device(t, tv, 16, 2048)
        nrm = nrm.contiguous()
    pose = torch.tensor(start, dtype=torch.float32, device=dev)
    for _ in range(20):
        partial = ks.icp_correspond_accumulate_plain(
            s, sv, t, tv, nrm, pose, 1.0, point_to_plane)
        rmse, nin = ks.icp_solve_update_plain(partial, pose, 1e-6)
    torch.cuda.synchronize()
    got_pose = torch.cat([got.rotation.reshape(9), got.translation])
    assert torch.equal(got_pose.view(torch.int32), pose.view(torch.int32))
    assert torch.equal(got.rmse.view(torch.int32), rmse.view(torch.int32))
    assert int(got.num_inliers) == int(nin) > 0


@pytest.mark.card
def test_kernel_wrapper_raises_on_the_card():
    """float64, non-contiguous or wrong-shape CUDA input raises."""
    _need_card()
    dev = torch.device("cuda")
    s = torch.rand((64, 3), device=dev)
    v = torch.ones(64, dtype=torch.bool, device=dev)
    pose = torch.tensor(IDENTITY, dtype=torch.float32, device=dev)
    bad = [
        (s.double(), v, s, v, pose),
        (torch.rand((3, 64), device=dev).T, v, s, v, pose),
        (s[:, :2].contiguous(), v, s, v, pose),
        (s, v, s, v, pose[:9]),
        (s, v.to(torch.uint8), s, v, pose),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ks.icp_correspond_accumulate(*args[:4], None, args[4], 1.0,
                                         False)
        with pytest.raises(ValueError):
            ks.icp_iterate(*args[:4], None, args[4], 1.0, False, 1e-6, 2)
    with pytest.raises(ValueError):
        ks.icp_correspond_accumulate(s, v, s, v, None, pose, 1.0, True)

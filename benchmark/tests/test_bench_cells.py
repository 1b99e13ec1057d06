"""Each cell run end to end on the CPU at a small size: the program's
answers agree with the reference; the control (the reference in the
precision below the stated one, put in the program's place) comes out not
correct; and a run whose timed path is broken underneath comes out not
correct, once for each fault a cell can have.  (No cell spans cards, so
the fault of an exchange between cards left out has no cell to break.)

The last test runs each control at the cells' own size on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import SEED, bench_json, cell, need_card, run_tiny
import harness

CELLS = ("ahn4-las-fold", "kitti-odometry", "ahn4-resident-step")


@pytest.mark.parametrize("name", CELLS)
def test_bench_cell_agrees_with_reference(name, tiny_root):
    out = run_tiny(tiny_root, name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    e2e = {m["name"] for m in bench_json()["end_to_end"]
           if name in m.get("workloads", [name])}
    assert set(out["metrics"]) == e2e
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_bench_cell_traced(name, tiny_root):
    out = run_tiny(tiny_root, name, trace=True)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in bench_json()["per_layer"]
            if name in m["workloads"]}
    # the CPU runs no kernel: the roofline has nothing to read
    want.discard("voxel_kernels_roofline")
    assert set(out["metrics"]) == want
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_bench_control_is_not_correct(name, tiny_root):
    out = run_tiny(tiny_root, name, control=True)
    assert not out["correct"], out["checks"]


# ---- faults planted under the timed path --------------------------------

def _fold_faults(mp, fault):
    import pasture_tpu_torch.io.streaming as streaming
    import pasture_tpu_torch.ops.voxel as voxel
    import pasture_tpu_torch.ops.voxel_merge as merge
    if fault == "state_unchanged":
        # the merge hands the accumulator back without the new chunk
        mp.setattr(merge, "merge_voxel_batches",
                   lambda parts, **kw: parts[0])
    elif fault == "half_left_out":
        real = voxel.voxel_downsample
        mp.setattr(voxel, "voxel_downsample", lambda b, *a, **kw: real(
            b.with_count(b.count // 2), *a, **kw))
    else:
        real = streaming.streaming_voxel_downsample

        def altered(*a, **kw):
            batch, aux = real(*a, **kw)
            pos = batch.data["Position3D"]
            pos[0, 0] += 0.25
            return batch, aux
        mp.setattr(streaming, "streaming_voxel_downsample", altered)


def _odometry_faults(mp, fault):
    import pasture_tpu_torch.pipeline as pipeline
    real = pipeline.RegistrationPipeline._align
    if fault == "state_unchanged":
        mp.setattr(pipeline.RegistrationPipeline, "_align",
                   lambda self, s, t: (np.eye(3), np.zeros(3)))
    elif fault == "half_left_out":
        real_pos = pipeline._positions
        mp.setattr(pipeline, "_positions",
                   lambda scan: real_pos(scan)[::2])
    else:
        def altered(self, s, t):
            rot, tr = real(self, s, t)
            return rot, tr + np.asarray([0.0, 0.2, 0.0])
        mp.setattr(pipeline.RegistrationPipeline, "_align", altered)


def _step_faults(mp, fault):
    import pasture_tpu_torch.ops.voxel as voxel
    real = voxel.voxel_downsample
    if fault == "state_unchanged":
        # every step hands back the first step's map
        first = {}

        def stale(*a, **kw):
            if "out" not in first:
                first["out"] = real(*a, **kw)
            return first["out"]
        mp.setattr(voxel, "voxel_downsample", stale)
    elif fault == "half_left_out":
        mp.setattr(voxel, "voxel_downsample", lambda b, *a, **kw: real(
            b.with_count(b.count // 2), *a, **kw))
    else:
        def altered(*a, **kw):
            out = real(*a, **kw)
            out.data["Position3D"][0, 2] += 0.25
            return out
        mp.setattr(voxel, "voxel_downsample", altered)


PLANT = {"ahn4-las-fold": _fold_faults, "kitti-odometry": _odometry_faults,
         "ahn4-resident-step": _step_faults}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_bench_fault_is_caught(name, fault, monkeypatch, tiny_root):
    PLANT[name](monkeypatch, fault)
    out = run_tiny(tiny_root, name)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_bench_control_full_size_on_card(name):
    need_card()
    for seed in (SEED, SEED + 1, SEED + 2):
        out = harness.run_cell(bench_json(), cell(name), seed, 1.0, False,
                               "cuda:0", control=True)
        assert not out["correct"], out["checks"]
        torch.cuda.empty_cache()

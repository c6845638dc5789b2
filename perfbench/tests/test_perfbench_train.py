"""Whole runs of the training cell on the CPU at a small size: a sound run
is correct; a step that leaves its state unchanged, half of each batch
left out, or a loss altered where it is produced is caught; the TF32
control fails the committed limit of the first step's loss."""
import json

import pytest

from perfbench.lib import harness, system
from perfbench.tests.helpers import (BENCH, NARROW, few_objects,
                                     no_import_check, small_tree)

# the small scenes' own fp32 rounding, which Adam's sign-like first steps
# amplify; the cell's limits are set at size
SMALL = {"loss_gap_step1": 1e-4, "grad_gap_mean": 0.05, "step_gap": 0.4}
CELL = "unet42-train-outdoor-b2"


def small_run(tmp_path, monkeypatch):
    few_objects(monkeypatch)
    no_import_check(monkeypatch)
    man, bench = small_tree(tmp_path, widths=NARROW, limits=SMALL,
                            mix_over={"pool": 3})
    return harness.run(CELL, 2 ** 31 + 12, 0.01, False, started=0.0,
                       device="cpu", manifest=man, bench=bench)


def test_a_sound_run_is_correct(tmp_path, monkeypatch):
    r = small_run(tmp_path, monkeypatch)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_scenes_per_s", "setup_s"}


def test_a_step_that_leaves_its_state_unchanged_is_caught(tmp_path,
                                                         monkeypatch):
    import repro_torch.train.pointcloud as tp
    from repro_torch.train.optimizer import OptState

    def unchanged(params, grads, state, cfg):
        return params, OptState(state.mu, state.nu, state.step + 1), {
            "grad_norm": next(iter(grads.values())).sum() * 0, "lr": 0.0}
    monkeypatch.setattr(tp, "apply_updates", unchanged)
    r = small_run(tmp_path, monkeypatch)
    assert not r["correct"]
    assert r["checks"]["step_gap"]["value"] == pytest.approx(1.0)


def test_half_of_each_batch_left_out_is_caught(tmp_path, monkeypatch):
    real = system.pack_labeled

    def first_scene_only(sess, batch):
        return real(sess, type(batch)(batch.coords[:1], batch.feats[:1],
                                      batch.labels[:1]))
    monkeypatch.setattr(system, "pack_labeled", first_scene_only)
    r = small_run(tmp_path, monkeypatch)
    assert not r["correct"]
    assert r["checks"]["loss_gap_step1"]["value"] > SMALL["loss_gap_step1"]


def test_a_loss_altered_where_it_is_produced_is_caught(tmp_path,
                                                      monkeypatch):
    import repro_torch.train.pointcloud as tp
    real = tp.segmentation_loss

    def altered(*a, **kw):
        loss, acc = real(*a, **kw)
        return loss * 1.001, acc
    monkeypatch.setattr(tp, "segmentation_loss", altered)
    r = small_run(tmp_path, monkeypatch)
    assert not r["correct"]


def test_the_tf32_control_fails_the_cells_limit(monkeypatch):
    from perfbench import control
    from perfbench.tests.test_perfbench_reference import small_cell
    c = small_cell(CELL, monkeypatch, pool=3)
    got = control.train_readings(c, 21, "cpu")
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    lim = limits["checks"]
    for fault in ("tf32", "half_batch"):
        assert any(got[fault][k] > lim[k] for k in lim if k in got[fault]), \
            (fault, got[fault])

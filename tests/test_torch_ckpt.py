"""The port's checkpoint manager (``repro_torch.ckpt``) on the CPU: the
integrity contract of ``tests/test_ckpt_robust.py`` mirrored test for test
(CRC32 verify-on-restore, fallback walk, orphan handling, last_good GC
exemption, async-writer error capture), keep-last-k, the host snapshot an
async save takes before it returns, and the format shared with the JAX
package: a checkpoint written by either restores in the other with
verification on, bitwise, and corruption made by either package's faults
module is caught by the other.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointCorruptionError as JCorrupt
from repro.ckpt import CheckpointManager as JManager
from repro.models import pointcloud as jpc
from repro.train import faults as jfaults
from repro.train import optimizer as jopt

from repro_torch.ckpt import (CheckpointCorruptionError, CheckpointManager,
                              CheckpointNotFoundError, CheckpointWriteError)
from repro_torch.convert import (opt_state_from_jax, opt_state_to_jax,
                                 params_from_jax, params_to_jax)
from repro_torch.models import pointcloud as tpc
from repro_torch.obs import MetricsRegistry
from repro_torch.train import faults as tfaults
from repro_torch.train.faults import (PreemptionError, corrupt_checkpoint,
                                      fail_next_write, preempt_between_files)
from repro_torch.train.guard import checkpoint_trees
from repro_torch.train.optimizer import AdamWConfig, init_opt_state

torch.set_num_threads(1)

CPU = "cpu"


def _params(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)
                                  * scale),
            "b": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))}


def _tree_equal(a, b):
    return all(a[k].numpy().tobytes() == b[k].numpy().tobytes() for k in b)


def _mgr(tmp_path, **kw):
    kw.setdefault("async_save", False)
    return CheckpointManager(str(tmp_path / "ck"), **kw)


# -- verify-on-restore --------------------------------------------------------

def test_restore_verifies_checksums_and_roundtrips(tmp_path):
    mgr = _mgr(tmp_path)
    p = _params(1)
    mgr.save(3, p)
    r, _, step = mgr.restore(None, _params(0))
    assert step == 3 and _tree_equal(r, p)
    with open(os.path.join(mgr.dir, "ckpt_00000003.json")) as f:
        meta = json.load(f)
    assert meta["format"] == 2
    assert set(meta["checksums"]) == {"params::w", "params::b"}


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_corruption_detected_with_file_named(tmp_path, mode):
    mgr = _mgr(tmp_path)
    mgr.save(1, _params(1))
    corrupt_checkpoint(mgr.dir, 1, mode=mode)
    template = _params(5)
    with pytest.raises(CheckpointCorruptionError) as ei:
        mgr.restore(None, template)
    assert "ckpt_00000001.npz" in str(ei.value)
    if mode == "flip":     # file still opens; the CRC names the bad array
        assert ei.value.key is not None
    assert mgr.verify_failures == 1
    assert _tree_equal(template, _params(5))   # nothing written


def test_fallback_walks_to_newest_verifying(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    for s in (1, 2, 3):
        mgr.save(s, _params(s))
    corrupt_checkpoint(mgr.dir, 3, mode="flip")
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(None, _params(0))
    r, _, step = mgr.restore(None, _params(0), fallback=True)
    assert step == 2 and _tree_equal(r, _params(2))
    assert mgr.verify_failures == 2   # one per restore attempt on step 3


def test_fallback_all_corrupt_aggregates(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    for s in (1, 2):
        mgr.save(s, _params(s))
        corrupt_checkpoint(mgr.dir, s, mode="flip")
    with pytest.raises(CheckpointCorruptionError) as ei:
        mgr.restore(None, _params(0), fallback=True)
    assert "all 2 candidate checkpoints failed" in str(ei.value)


def test_verify_false_skips_checksums(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _params(1))
    corrupt_checkpoint(mgr.dir, 1, mode="flip")   # npz still readable
    _, _, step = mgr.restore(None, _params(1), verify=False)
    assert step == 1   # trusted blindly — caller opted out


def test_format1_manifest_restores_without_verification(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _params(1))
    with open(os.path.join(mgr.dir, "ckpt_00000001.json"), "w") as f:
        json.dump({"step": 1}, f)
    r, _, step = mgr.restore(None, _params(0))
    assert step == 1 and _tree_equal(r, _params(1))


# -- typed errors -------------------------------------------------------------

def test_missing_step_raises_not_found(tmp_path):
    mgr = _mgr(tmp_path)
    with pytest.raises(CheckpointNotFoundError):
        mgr.restore(None, _params(0))
    mgr.save(1, _params(1))
    with pytest.raises(CheckpointNotFoundError):
        mgr.restore(7, _params(0))


def test_template_mismatch_is_typed_and_names_key(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(CheckpointCorruptionError) as ei:
        mgr.restore(None, {"w": torch.ones(2), "extra": torch.ones(3)})
    assert ei.value.key == "params::extra"
    with pytest.raises(CheckpointCorruptionError) as ei:
        mgr.restore(None, {"w": torch.ones(3)})
    assert ei.value.key == "params::w" and "shape" in ei.value.reason


# -- preemption between npz and manifest (the torn state) --------------------

def test_preempted_save_leaves_rejectable_orphan(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, _params(1))
    preempt_between_files(mgr)
    with pytest.raises(PreemptionError):
        mgr.save(2, _params(2))
    assert mgr.steps() == [1, 2]
    assert mgr.complete_steps() == [1]
    with pytest.raises(CheckpointCorruptionError) as ei:
        mgr.restore(2, _params(0))
    assert "manifest missing" in str(ei.value)
    _, _, step = mgr.restore(2, _params(0), verify=False)
    assert step == 2
    r, _, step = mgr.restore(None, _params(0), fallback=True)
    assert step == 1 and _tree_equal(r, _params(1))


def test_gc_cleans_both_orphan_kinds(tmp_path):
    mgr = _mgr(tmp_path, keep=3)
    preempt_between_files(mgr)
    with pytest.raises(PreemptionError):
        mgr.save(1, _params(1))
    assert mgr.steps() == [1] and mgr.complete_steps() == []
    with open(os.path.join(mgr.dir, "ckpt_00000099.json"), "w") as f:
        json.dump({"step": 99}, f)
    mgr.save(2, _params(2))
    assert mgr.complete_steps() == [2]
    assert mgr.steps() == [2]
    assert not os.path.exists(os.path.join(mgr.dir, "ckpt_00000099.json"))


def test_gc_spares_newest_npz_in_flight(tmp_path):
    mgr = _mgr(tmp_path, keep=2)
    preempt_between_files(mgr)
    with pytest.raises(PreemptionError):
        mgr.save(5, _params(5))
    mgr._gc()
    assert mgr.steps() == [5]


# -- last_good tag ------------------------------------------------------------

def test_last_good_exempt_from_gc(tmp_path):
    mgr = _mgr(tmp_path, keep=2)
    mgr.save(1, _params(1))
    mgr.mark_last_good(1)
    for s in (2, 3, 4, 5):
        mgr.save(s, _params(s))
    assert mgr.complete_steps() == [1, 4, 5]
    assert mgr.last_good_step() == 1
    r, _, _ = mgr.restore(1, _params(0))
    assert _tree_equal(r, _params(1))


def test_mark_last_good_requires_complete_checkpoint(tmp_path):
    mgr = _mgr(tmp_path)
    with pytest.raises(CheckpointNotFoundError):
        mgr.mark_last_good(3)
    assert mgr.last_good_step() is None


# -- async writer error capture -----------------------------------------------

def test_async_write_failure_reraised_on_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    fail_next_write(mgr)
    mgr.save(1, _params(1))               # async: failure lands off-thread
    with pytest.raises(CheckpointWriteError) as ei:
        mgr.save(2, _params(2))
    assert "injected disk full" in str(ei.value)
    mgr.save(2, _params(2))
    mgr.wait()
    assert mgr.complete_steps() == [2]


def test_async_write_failure_reraised_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    fail_next_write(mgr, RuntimeError("torn write"))
    mgr.save(1, _params(1))
    with pytest.raises(CheckpointWriteError) as ei:
        mgr.wait()
    assert "torn write" in str(ei.value)
    mgr.wait()                            # consumed once, not forever


def test_sync_write_failure_raises_immediately(tmp_path):
    mgr = _mgr(tmp_path)
    fail_next_write(mgr)
    with pytest.raises(OSError):
        mgr.save(1, _params(1))
    mgr.save(1, _params(1))
    assert mgr.complete_steps() == [1]


def test_checkpoint_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, async_save=False)
    params = {"w": torch.ones(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, params)
    assert mgr.steps() == [3, 4]


def test_async_save_holds_the_pre_step_bytes(tmp_path):
    """The snapshot is taken before save returns: an in-place update right
    after it (the next training step) must not reach the file. On the CPU
    ``.cpu()`` would share the storage, so the snapshot copies."""
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)
    p = {"w": torch.from_numpy(np.arange(1 << 16, dtype=np.float32))}
    before = p["w"].clone()
    mgr.save(1, p)
    p["w"].add_(1.0)                      # the step's in-place update
    mgr.wait()
    r, _, _ = mgr.restore(1, {"w": torch.zeros(1 << 16)})
    assert torch.equal(r["w"], before)


# -- the format shared with the JAX package -----------------------------------

def _tiny():
    make = lambda m: m.tiny_segnet(in_channels=4, n_classes=6, width=8,
                                   depth=3)
    jnet, tnet = make(jpc), make(tpc)
    jparams = jpc.init_pointcloud(jax.random.key(3), jnet)
    cfg = jopt.AdamWConfig(warmup_steps=1, total_steps=10)
    grads = jax.tree.map(lambda x: x * 0.5 + 0.01, jparams)
    jparams, jstate, _ = jopt.apply_updates(
        jparams, grads, jopt.init_opt_state(jparams, cfg), cfg)
    return jnet, tnet, jparams, jstate


def _port_blank(tnet):
    model = tpc.init_pointcloud(tnet, seed=9, device=CPU)
    state = init_opt_state(dict(model.named_parameters()), AdamWConfig())
    return model, state


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _same_bits(a, b):
    return (len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(a, b)))


def test_params_and_opt_state_to_jax_invert_from_jax():
    _, tnet, jparams, jstate = _tiny()
    jp = jax.tree.map(np.asarray, jparams)
    js = jax.tree.map(np.asarray, jstate)
    model = params_from_jax(jp, tnet, device=CPU)
    state = opt_state_from_jax(js, tnet, device=CPU)
    assert _same_bits(_np_leaves(params_to_jax(model, tnet)),
                      _np_leaves(jp))
    back = opt_state_to_jax(state, tnet)
    assert _same_bits(_np_leaves(back.mu), _np_leaves(js.mu))
    assert _same_bits(_np_leaves(back.nu), _np_leaves(js.nu))
    assert back.step.dtype == np.int32 and int(back.step) == 1
    assert tpc.jax_param_paths(tnet)["layers.stem.weight"] == "stem/w"


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A JAX-written checkpoint restores into the port's model and AdamW
    state with verification on: bitwise float32, the step equal, the
    model's Parameter objects kept."""
    _, tnet, jparams, jstate = _tiny()
    d = str(tmp_path / "ck")
    JManager(d, async_save=False).save(7, jparams, jstate)
    model, state = _port_blank(tnet)
    ids = [id(p) for p in model.parameters()]
    mgr = CheckpointManager(d, async_save=False)
    p, o, step = mgr.restore(None, *checkpoint_trees(model, state),
                             verify=True)
    assert [id(q) for q in model.parameters()] == ids
    assert p["stem"]["w"] is model.layers["stem"].weight
    assert o[".mu"]["head"] is state.mu["head"]
    assert o[".step"].dtype == np.int32 and int(o[".step"]) == 1
    assert step == 7 and mgr.verify_failures == 0
    assert _same_bits(_np_leaves(params_to_jax(model, tnet)),
                      _np_leaves(jparams))
    got = opt_state_to_jax(state, tnet)
    assert _same_bits(_np_leaves(got.mu), _np_leaves(jstate.mu))
    assert _same_bits(_np_leaves(got.nu), _np_leaves(jstate.nu))


def test_port_checkpoint_restores_into_jax(tmp_path):
    """A port-written checkpoint restores into the JAX manager with
    verification on; both packages write the same keys, dtypes and
    shapes."""
    jnet, tnet, jparams, jstate = _tiny()
    model = params_from_jax(jax.tree.map(np.asarray, jparams), tnet,
                            device=CPU)
    state = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tnet,
                               device=CPU)
    dp, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    CheckpointManager(dp, async_save=False).save(
        4, *checkpoint_trees(model, state))
    JManager(dj, async_save=False).save(4, jparams, jstate)
    with np.load(os.path.join(dp, "ckpt_00000004.npz")) as zp, \
            np.load(os.path.join(dj, "ckpt_00000004.npz")) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        assert "opt::.step" in zp.files and "params::stem/w" in zp.files
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype and zp[k].shape == zj[k].shape
            assert zp[k].tobytes() == zj[k].tobytes(), k
    blank = jpc.init_pointcloud(jax.random.key(11), jnet)
    jm = JManager(dp, async_save=False)
    p, o, step = jm.restore(None, blank, jopt.init_opt_state(
        blank, jopt.AdamWConfig()), verify=True)
    assert step == 4 and int(o.step) == 1 and jm.verify_failures == 0
    assert _same_bits(_np_leaves(p), _np_leaves(jparams))
    assert _same_bits(_np_leaves(o), _np_leaves(jstate))


@pytest.mark.parametrize("mode", ["flip", "truncate"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corruption_by_either_faults_module_caught_by_the_other(
        tmp_path, writer, mode):
    jnet, tnet, jparams, jstate = _tiny()
    d = str(tmp_path / "ck")
    if writer == "jax":
        JManager(d, async_save=False).save(2, jparams, jstate)
        tfaults.corrupt_checkpoint(d, 2, mode=mode)
        jm = JManager(d, async_save=False)
        with pytest.raises(JCorrupt) as ei:
            jm.restore(None, jparams, jstate)
    else:
        model = params_from_jax(jax.tree.map(np.asarray, jparams), tnet,
                                device=CPU)
        state = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tnet,
                                   device=CPU)
        CheckpointManager(d, async_save=False).save(
            2, *checkpoint_trees(model, state))
        jfaults.corrupt_checkpoint(d, 2, mode=mode)
        with pytest.raises(CheckpointCorruptionError) as ei:
            CheckpointManager(d, async_save=False).restore(
                None, *checkpoint_trees(model, state))
    assert "ckpt_00000002.npz" in str(ei.value)
    if mode == "flip":
        assert ei.value.key.startswith("opt::.mu/")   # the first sorted


def test_manager_records_spans_and_bytes(tmp_path):
    mgr = _mgr(tmp_path, metrics=MetricsRegistry())
    mgr.save(1, _params(1))
    mgr.restore(None, _params(0))
    snap = mgr.metrics.snapshot()
    for name in ("ckpt/snapshot", "ckpt/save", "ckpt/restore"):
        assert snap["histograms"][name]["count"] == 1
    assert snap["counters"]["ckpt_bytes_written"] == (32 + 4) * 4
    assert snap["counters"]["ckpt_bytes_read"] == (32 + 4) * 4

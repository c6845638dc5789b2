"""The port's LM training loop against the JAX package: the five training
tests of ``tests/test_train_serve_ckpt.py`` on the port (loss decreases
over 30 steps, grad_accum 4 vs 1, checkpoint restart bit-exact,
compression error feedback, deterministic data resume); one
``make_train_step`` step against the reference's jitted step from the same
converted parameters and AdamW state; ``compress_tree``'s int8 codes equal
to the reference's; ``batch_at`` equal to the reference's; LM checkpoints
crossing packages both ways with CRC32 verification on; the launcher on
the CPU (a run, ``--resume`` bitwise a straight run, the refusals); SIGTERM
checkpointing and stopping ``train``.

Tolerances: a step's loss and gradient norm within ``1e-5`` relative,
both moments of every leaf within ``1e-4`` of the leaf's largest
magnitude (the gradient leaves agree within 5e-5,
``tests/test_torch_lm_train.py``; the norm sums in another order,
``train.loop``); every parameter within that or ``1e-2`` of the step's
learning rate: AdamW's update m/(√v + ε) is O(1) for any gradient
magnitude, so an element whose gradient is small against its leaf's
largest moves by a fraction of ``lr`` under the gradients' rounding
(measured 1.8e-3 of ``lr``); grad_accum 4 vs 1 as the reference's own test
(rtol 1e-4, atol 1e-5).
"""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JManager
from repro.data import tokens as jtokens
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.train import compression as jcomp
from repro.train import loop as jloop
from repro.train import optimizer as jopt

from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import (lm_opt_state_from_jax, lm_opt_state_to_jax,
                                 lm_params_from_jax, lm_params_to_jax)
from repro_torch.data.tokens import DataConfig, batch_at, stream
from repro_torch.launch import train as launch_train
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.train import (AdamWConfig, TrainConfig, compression,
                               init_opt_state, make_train_step, train)
from repro_torch.train.loop import checkpoint_trees, restore

torch.set_num_threads(1)
CPU = "cpu"


def tiny():
    return tcommon.dense_lm("tiny", n_layers=2, d_model=64, n_heads=4,
                            n_kv=2, d_ff=128, vocab=128, dtype="float32")


def jtiny():
    return jcommon.dense_lm("tiny", n_layers=2, d_model=64, n_heads=4,
                            n_kv=2, d_ff=128, vocab=128, dtype="float32")


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what=""):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, what
    d = float(np.abs(got - want).max())
    assert d <= rel * max(float(np.abs(want).max()), 1e-30), (what, d)


# -- the five training tests of test_train_serve_ckpt.py --------------------

def test_train_loss_decreases():
    cfg = tiny()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=1)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=5,
                                       total_steps=60),
                       remat=False, log_every=1000, ckpt_every=10**9)
    params, opt, metrics = train(cfg, tcfg, stream(dcfg), n_steps=30,
                                 log=None, device=CPU)
    first = batch_at(dcfg, 0)
    l_end = float(ttf.loss_fn(params, cfg, first))
    p0 = ttf.init_params(cfg, 0, device=CPU)[0]
    l_start = float(ttf.loss_fn(p0, cfg, first))
    assert l_end < l_start - 0.2, (l_start, l_end)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def test_grad_accum_matches_single_batch():
    cfg = tiny()
    params = ttf.init_params(cfg, 0, device=CPU)[0]
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=2)
    batch = batch_at(dcfg, 0)
    out = []
    for accum in (1, 4):
        p = _clone(params)
        o = init_opt_state(p, AdamWConfig())
        step = make_train_step(cfg, TrainConfig(remat=False,
                                                grad_accum=accum))
        out.append(step(p, o, batch)[0])
    for a, b in zip(_leaves(out[0]), _leaves(out[1])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)


def test_checkpoint_restart_bitexact(tmp_path):
    """Kill/resume equivalence: 6 steps straight == 3, restore, 3 more
    (parameters bit-identical), the data stream resumed too."""
    cfg = tiny()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=3)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3), remat=False,
                       log_every=10**9, ckpt_every=3)
    pA, oA, _ = train(cfg, tcfg, stream(dcfg), n_steps=6, log=None,
                      device=CPU)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    train(cfg, tcfg, stream(dcfg), n_steps=3, ckpt_manager=mgr, log=None,
          device=CPU)
    mgr.wait()
    tmpl_p = ttf.init_params(cfg, 5, device=CPU)[0]
    pR, oR, step = restore(mgr, tmpl_p, init_opt_state(tmpl_p, tcfg.opt))
    assert step == 2 and oR.step == 3
    pC, oC, _ = train(cfg, tcfg, stream(dcfg, start_step=3), n_steps=6,
                      params=pR, opt_state=oR, start_step=3, log=None)
    for a, b in zip(_leaves(pA), _leaves(pC)):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(oA.nu), _leaves(oC.nu)):
        assert torch.equal(a, b)


def test_compression_error_feedback_convergence():
    """Quantized, error-fed gradients accumulated over steps approximate
    the true sum (the residual carries what a step dropped)."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(512,)) * 1e-3).float()}
    res = None
    acc_q = torch.zeros((512,))
    for _ in range(50):
        q, res = compression.compress_tree(g, res)
        acc_q = acc_q + q["w"]
    np.testing.assert_allclose(acc_q.numpy(), g["w"].numpy() * 50,
                               rtol=0.02, atol=1e-4)


def test_data_stream_deterministic_resume():
    dcfg = DataConfig(vocab=100, seq_len=16, global_batch=2, seed=9)
    a = next(stream(dcfg, 5))
    b = batch_at(dcfg, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


# -- against the reference ----------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_step_matches_reference_step(accum):
    """From the same converted parameters and a nonzero AdamW state (one
    reference step in), one port step and one reference jitted step:
    loss, grad norm, every parameter and both moments of every leaf."""
    jc, tc = jtiny(), tiny()
    jp = jtf.init_params(jc, jax.random.key(0))[0]
    ocfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2)
    dcfg = jtokens.DataConfig(vocab=jc.vocab, seq_len=24, global_batch=4,
                              seed=4)
    jstep = jax.jit(jloop.make_train_step(jc, jloop.TrainConfig(
        opt=ocfg, remat=False, grad_accum=accum)))
    jo = jopt.init_opt_state(jp, ocfg)
    jp, jo, _ = jstep(jp, jo, jax.tree.map(jnp.asarray,
                                           jtokens.batch_at(dcfg, 0)))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc, device=CPU)
    to = lm_opt_state_from_jax(jax.tree.map(np.asarray, jo), tc, device=CPU)
    batch = jtokens.batch_at(dcfg, 1)
    jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, batch))
    tstep = make_train_step(tc, TrainConfig(
        opt=AdamWConfig(lr=1e-2, warmup_steps=2), remat=False,
        grad_accum=accum))
    tp, to, tm = tstep(tp, to, batch)
    assert to.step == int(jo.step) == 2
    _close(tm["loss"], jm["loss"], 1e-5, "loss")
    _close(tm["grad_norm"], jm["grad_norm"], 1e-5, "grad_norm")
    assert abs(tm["lr"] - float(jm["lr"])) <= 1e-6 * float(jm["lr"])
    for a, b in zip(_leaves(lm_params_to_jax(tp)),
                    _leaves(jax.tree.map(np.asarray, jp))):
        assert float(np.abs(a - b).max()) <= max(
            1e-4 * float(np.abs(b).max()), 1e-2 * tm["lr"])
    for name, got, want in (("mu", lm_opt_state_to_jax(to).mu, jo.mu),
                            ("nu", lm_opt_state_to_jax(to).nu, jo.nu)):
        want = jax.tree.map(np.asarray, want)
        for a, b in zip(_leaves(got), _leaves(want)):
            _close(a, b, 1e-4, name)


def test_compress_tree_codes_equal_reference():
    """int8 codes and scales bitwise the reference's (blocks of 1024 over
    a flattened leaf, ragged last block, half-way values rounded to even),
    the dequantized tree and the residual within fp32 rounding."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(3, 700)).astype(np.float32),
            "b": {"c": (rng.integers(-254, 255, (2048,)) / 2.0 / 127.0
                        ).astype(np.float32)}}
    res = {"a": rng.normal(size=(3, 700)).astype(np.float32) * 1e-3,
           "b": {"c": np.zeros((2048,), np.float32)}}
    for leaf, r in ((tree["a"], res["a"]), (tree["b"]["c"], res["b"]["c"])):
        jq, js = jcomp.quantize(jnp.asarray(leaf + r))
        tq, ts = compression.quantize(torch.from_numpy(leaf + r))
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.array_equal(ts.numpy(), np.asarray(js))
    jg, jr = jcomp.compress_tree(jax.tree.map(jnp.asarray, tree),
                                 jax.tree.map(jnp.asarray, res))
    tg, tr = compression.compress_tree(
        jax.tree.map(torch.from_numpy, tree),
        jax.tree.map(torch.from_numpy, res))
    for a, b in zip(_leaves(tg), _leaves(jax.tree.map(np.asarray, jg))):
        assert np.array_equal(_np(a), b)
    for a, b in zip(_leaves(tr), _leaves(jax.tree.map(np.asarray, jr))):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("seed,step,prefix", [(0, 0, 0), (3, 7, 0),
                                              (11, 2, 8), (5, 40, 4)])
def test_batch_at_equal_reference(seed, step, prefix):
    kw = dict(vocab=97, seq_len=32, global_batch=3, seed=seed,
              embed_dim=16 if prefix else 0, embed_prefix=prefix)
    want = jtokens.batch_at(jtokens.DataConfig(**kw), step)
    got = batch_at(DataConfig(**kw), step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k


def _trained_pair():
    """A reference tiny LM one step in: (its params, its OptState)."""
    jc = jtiny()
    jp = jtf.init_params(jc, jax.random.key(2))[0]
    ocfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=1)
    jo = jopt.init_opt_state(jp, ocfg)
    jp, jo, _ = jax.jit(jloop.make_train_step(jc, jloop.TrainConfig(
        opt=ocfg, remat=False)))(jp, jo, jax.tree.map(
            jnp.asarray, jtokens.batch_at(jtokens.DataConfig(
                vocab=jc.vocab, seq_len=16, global_batch=2), 0)))
    return jp, jo


def _same_bits(a_tree, b_tree):
    return all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
               for a, b in zip(_leaves(a_tree), _leaves(b_tree)))


def test_lm_checkpoint_jax_to_port(tmp_path):
    jp, jo = _trained_pair()
    d = str(tmp_path / "ck")
    JManager(d, async_save=False).save(5, jp, jo)
    tp = ttf.init_params(tiny(), 9, device=CPU)[0]
    to = init_opt_state(tp, AdamWConfig())
    ids = [id(t) for t in _leaves(tp)]
    mgr = CheckpointManager(d, async_save=False)
    p, o, step = restore(mgr, tp, to, verify=True)
    assert step == 5 and o.step == 1 and mgr.verify_failures == 0
    assert [id(t) for t in _leaves(p)] == ids
    assert _same_bits(lm_params_to_jax(p), jax.tree.map(np.asarray, jp))
    back = lm_opt_state_to_jax(o)
    assert _same_bits(back.mu, jax.tree.map(np.asarray, jo.mu))
    assert _same_bits(back.nu, jax.tree.map(np.asarray, jo.nu))


def test_lm_checkpoint_port_to_jax(tmp_path):
    jp, jo = _trained_pair()
    tc = tiny()
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc, device=CPU)
    to = lm_opt_state_from_jax(jax.tree.map(np.asarray, jo), tc, device=CPU)
    dp, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    CheckpointManager(dp, async_save=False).save(3, *checkpoint_trees(tp, to))
    JManager(dj, async_save=False).save(3, jp, jo)
    with np.load(os.path.join(dp, "ckpt_00000003.npz")) as zp, \
            np.load(os.path.join(dj, "ckpt_00000003.npz")) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        assert "opt::.step" in zp.files and "params::sb0/b0/wq" in zp.files
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype and zp[k].shape == zj[k].shape
            assert zp[k].tobytes() == zj[k].tobytes(), k
    blank = jtf.init_params(jtiny(), jax.random.key(7))[0]
    jm = JManager(dp, async_save=False)
    p, o, step = jm.restore(None, blank, jopt.init_opt_state(
        blank, jopt.AdamWConfig()), verify=True)
    assert step == 3 and int(o.step) == 1 and jm.verify_failures == 0
    assert _same_bits(p, jax.tree.map(np.asarray, jp))
    assert _same_bits(o.mu, jax.tree.map(np.asarray, jo.mu))


def test_bf16_checkpoint_round_trip(tmp_path):
    """bf16 leaves land as the reference's raw 2-byte ``|V2`` arrays and
    restore bitwise."""
    cfg = tcommon.dense_lm("tinyb", n_layers=2, d_model=64, n_heads=4,
                           n_kv=2, d_ff=128, vocab=128)
    p = ttf.init_params(cfg, 1, device=CPU)[0]
    o = init_opt_state(p, AdamWConfig())
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(0, *checkpoint_trees(p, o))
    with np.load(os.path.join(mgr.dir, "ckpt_00000000.npz")) as z:
        assert z["params::embed"].dtype.str == "|V2"
    q = ttf.init_params(cfg, 2, device=CPU)[0]
    restore(mgr, q, init_opt_state(q, AdamWConfig()), verify=True)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(p), _leaves(q)))


# -- the launcher and the loop's hooks ----------------------------------------

def _run(tmp_path, name, *extra):
    launch_train.main(["--arch", "yi-9b", "--smoke", "--seq-len", "32",
                       "--global-batch", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / name), *extra])


def test_launcher_runs_and_resumes_bitwise(tmp_path, capsys):
    _run(tmp_path, "a", "--steps", "5")
    _run(tmp_path, "b", "--steps", "3")
    _run(tmp_path, "b", "--steps", "5", "--resume")
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert "done; checkpoints: [0, 2, 4]" in out
    with np.load(tmp_path / "a" / "ckpt_00000004.npz") as za, \
            np.load(tmp_path / "b" / "ckpt_00000004.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].tobytes() == zb[k].tobytes(), k


@pytest.mark.parametrize("extra,why", [
    (["--mesh", "16x16"], "sharded"), (["--mesh", "2x16x16"], "sharded"),
    (["--arch", "musicgen-medium"], "embedding-input")])
def test_launcher_refuses(tmp_path, extra, why):
    args = ["--arch", "yi-9b", "--smoke", "--steps", "1", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "x")]
    with pytest.raises(SystemExit, match=why):
        launch_train.main(args + extra)


def test_sigterm_checkpoints_and_stops(tmp_path):
    """SIGTERM during a step: ``train`` checkpoints that step and stops."""
    cfg = tiny()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)

    def data():
        for i, b in enumerate(stream(dcfg)):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b
    saved = signal.getsignal(signal.SIGTERM)
    lines = []
    try:
        mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
        train(cfg, TrainConfig(remat=False, ckpt_every=100), data(),
              n_steps=10, ckpt_manager=mgr, log=lines.append, device=CPU)
    finally:
        signal.signal(signal.SIGTERM, saved)
    assert mgr.steps() == [0, 2]
    assert lines[-1] == "[preempt] checkpointed at step 2, exiting"

"""The port's MoE, Mamba, mLSTM and sLSTM blocks against the JAX package,
at the fp32 smoke configs of qwen3-moe, kimi-k2 (a shared expert), jamba
and xlstm, with the JAX parameters converted by
``convert.lm_params_from_jax`` and the same inputs drawn from numpy seeds.

MoE routing is compared first and exactly: the expert ids, each choice's
position within its expert and the kept set (also with a capacity factor
that drops choices), then the outputs. Block outputs and every state leaf
within ``1e-5 * max|ref|`` (the tolerance of ``tests/test_torch_lm.py``);
mLSTM over hundreds of steps within its whole-model ``5e-5``, where the
reference's own sensitivity is shown to exceed ``1e-5``.
The port's Mamba recurrence is a loop over each chunk's steps where the
reference runs a parallel associative scan: the two differ only in
rounding, well inside that tolerance at these sizes. The chunked scans'
invariance to the chunk size mirrors ``tests/test_models.py`` on the port.
Also: every configured architecture builds (no ``NotImplementedError``),
its parameter tree has the JAX tree's shapes, the loss (which raised
until LM training was ported) equals the reference's, and the sliced
draw of large leaves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models import xlstm as jxlstm

from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import common as tcommon
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as txlstm

torch.set_num_threads(1)

BLOCK_RTOL = 1e-5
MODEL_RTOL = 5e-5
MOE = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]
JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-350m"


def N(t):
    return t.detach().float().numpy()


def assert_close(got, want, rel, what=""):
    """max |got - want| <= rel * max(1e-30, max |want|), in fp32."""
    got = N(got) if isinstance(got, torch.Tensor) else np.asarray(got,
                                                                   np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    d = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert d <= rel * max(scale, 1e-30), (what, d, scale,
                                         d / max(scale, 1e-30))


_PARAMS = {}


def _params(arch, **replace):
    """(JAX config, port config, JAX params, port params), cached."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _PARAMS:
        jc = jconfigs.get_config(arch, smoke=True)
        tc = tconfigs.get_config(arch, smoke=True)
        if replace:
            jc = dataclasses.replace(jc, **replace)
            tc = dataclasses.replace(tc, **replace)
        jp = jtf.init_params(jc, jax.random.key(0))[0]
        tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                device="cpu")
        _PARAMS[key] = (jc, tc, jp, tp)
    return _PARAMS[key]


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _tlayer(tree, i=0):
    return {k: v[i] for k, v in tree.items()}


def _x(cfg, B=2, S=11, seed=2, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, cfg.d_model)) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# every architecture builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_every_arch_is_supported_with_the_jax_trees_shapes(arch):
    """No configured architecture raises, full-size or smoke, and the
    port's parameter tree (``param_shapes``, which ``lm_params_from_jax``
    checks against) has the JAX tree's shapes, without allocating."""
    for smoke in (False, True):
        jc = jconfigs.get_config(arch, smoke=smoke)
        tc = tconfigs.get_config(arch, smoke=smoke)
        ttf.check_supported(tc)
        want = jax.tree.map(lambda a: tuple(a.shape),
                            jtf.abstract_params(jc)[0])
        assert ttf.param_shapes(tc) == want


def test_loss_still_raises():
    """The loss raised until LM training was ported (ROADMAP item 7.3); it
    now runs on the xLSTM's parameters and equals the reference's (its
    gradients: ``tests/test_torch_lm_train_archs.py``)."""
    jc, tc, jp, tp = _params(XLSTM)
    batch = {"tokens": np.zeros((1, 4), np.int32),
             "labels": np.zeros((1, 4), np.int32)}
    got = float(ttf.loss_fn(tp, tc, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}))
    want = float(jtf.loss_fn(jp, jc, {k: jnp.asarray(v)
                                      for k, v in batch.items()}))
    assert np.isfinite(got) and abs(got - want) <= 5e-5 * abs(want)


def test_check_supported_refuses_unknown_kinds():
    _, tc, _, _ = _params(XLSTM)
    bad = dataclasses.replace(tc, superblocks=(tcommon.SuperBlock(
        blocks=(("rnn", "none"),), repeat=1),))
    with pytest.raises(ValueError, match="rnn"):
        ttf.init_params(bad, 0, device="cpu")[0]


def test_init_params_of_the_new_leaves():
    """Seeded and reproducible; ``A_log`` the reference's constant (its
    fp32 log within an ulp: XLA's and torch's ``log`` round differently),
    ``D``
    and the forget-gate bias ones, norms zero; the experts' weights at
    1/√fan_in."""
    jc, tc, _, _ = _params(JAMBA)
    p = ttf.init_params(tc, 0, device="cpu")[0]
    q = ttf.init_params(tc, 0, device="cpu")[0]
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(p),
                                                 jax.tree.leaves(q)))
    jp = jtf.init_params(jc, jax.random.key(0))[0]
    mb, jmb = p["sb0"]["b0"], jp["sb0"]["b0"]
    np.testing.assert_allclose(N(mb["A_log"]), np.asarray(jmb["A_log"]),
                               rtol=1.2e-7, atol=0)
    assert float((mb["D"] - 1).abs().max()) == 0.0
    assert float(mb["norm"].abs().max()) == 0.0
    wi = p["sb0"]["f0"]["wi"]                     # [R, E, dm, 2, dff]
    assert abs(float(wi.std()) * np.sqrt(wi.shape[-2]) - 1) < 0.05
    xp = ttf.init_params(_params(XLSTM)[1], 0, device="cpu")[0]
    assert float((xp["sb0"]["b0"]["bf"] - 1).abs().max()) == 0.0
    assert "embed" in xp and "lm_head" not in xp           # tied
    mg = ttf.init_params(tconfigs.get_config("musicgen-medium", smoke=True),
                         0, device="cpu")[0]
    assert "embed" not in mg and "lm_head" in mg           # embedding inputs


def test_large_leaves_are_drawn_in_slices(monkeypatch):
    """A layer above ``DRAW_LIMIT`` elements is drawn slice by slice along
    its first axis: seeded, every slice distinct, the same scale."""
    monkeypatch.setattr(tcommon, "DRAW_LIMIT", 64 * 32)
    gen = torch.Generator().manual_seed(3)
    sliced = tcommon.ParamCtx(gen, torch.float32, "cpu", stack=2).param(
        "w", (4, 64, 32), (None, None, None))
    gen = torch.Generator().manual_seed(3)
    again = tcommon.ParamCtx(gen, torch.float32, "cpu", stack=2).param(
        "w", (4, 64, 32), (None, None, None))
    assert torch.equal(sliced, again)
    assert abs(float(sliced.std()) * np.sqrt(64) - 1) < 0.05
    assert not torch.equal(sliced[0, 0], sliced[0, 1])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _jax_routing(jp, jc, x):
    """The reference's routing lines of ``moe_fwd`` (``repro/models/
    moe.py:54-66``): expert ids, positions, kept choices, gates."""
    E, k = jc.n_experts, jc.top_k
    h = jcommon.rms_norm(x, jp["norm"], jc.norm_eps).reshape(-1, jc.d_model)
    n = h.shape[0]
    logits = jnp.einsum("nd,de->ne", h.astype(jnp.float32),
                        jp["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, eidx = jax.lax.top_k(probs, k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(eidx, E, dtype=jnp.int32)
    flat = onehot.reshape(n * k, E)
    rank = (jnp.cumsum(flat, axis=0) - flat).reshape(n, k, E)
    pos = (rank * onehot).sum(-1)
    return (np.asarray(logits), np.asarray(gate), np.asarray(eidx),
            np.asarray(pos), np.asarray(pos < jmoe.capacity_for(jc, n)))


def _moe_case(arch, capacity_factor=None, B=2, S=11):
    replace = ({} if capacity_factor is None
               else {"capacity_factor": capacity_factor})
    jc, tc, jp, tp = _params(arch, **replace)
    x = _x(jc, B=B, S=S)
    return jc, tc, _layer(jp["sb0"]["f0"]), _tlayer(tp["sb0"]["f0"]), x


def _check_routing(jc, tc, jf, tf_, x):
    logits, gate, eidx, pos, keep = _jax_routing(jf, jc, jnp.asarray(x))
    h = tcommon.rms_norm(torch.from_numpy(x), tf_["norm"],
                         tc.norm_eps).reshape(-1, tc.d_model)
    tl, tg, te, tpos, tkeep = tmoe.route(tf_, tc, h)
    assert_close(tl, logits, BLOCK_RTOL, "router logits")
    probs = np.sort(np.asarray(jax.nn.softmax(logits, -1)), -1)
    gap = float(np.min(probs[:, -tc.top_k] - probs[:, -tc.top_k - 1]))
    assert np.array_equal(te.numpy(), eidx), ("expert ids differ; the "
                                              f"closest top-k gap is {gap}")
    assert np.array_equal(tpos.numpy(), pos)
    assert np.array_equal(tkeep.numpy(), keep)
    assert_close(tg, gate, BLOCK_RTOL, "gates")
    return keep


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_equal(arch):
    jc, tc, jf, tf_, x = _moe_case(arch)
    keep = _check_routing(jc, tc, jf, tf_, x)
    assert keep.all()                       # capacity factor 2: none dropped


@pytest.mark.parametrize("arch", MOE)
def test_moe_fwd(arch):
    jc, tc, jf, tf_, x = _moe_case(arch)
    want = jmoe.moe_fwd(jf, jc, jnp.asarray(x))
    got = tmoe.moe_fwd(tf_, tc, torch.from_numpy(x))
    assert_close(got, want, BLOCK_RTOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_fwd_drops_the_same_choices(arch):
    """A capacity factor of 0.25 over 64 tokens: some experts overflow
    their 8 slots; the kept set and the outputs equal the reference's."""
    jc, tc, jf, tf_, x = _moe_case(arch, capacity_factor=0.25, S=32)
    keep = _check_routing(jc, tc, jf, tf_, x)
    assert not keep.all()
    want = jmoe.moe_fwd(jf, jc, jnp.asarray(x))
    got = tmoe.moe_fwd(tf_, tc, torch.from_numpy(x))
    assert_close(got, want, BLOCK_RTOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_shape(arch):
    """One token per slot (the decode step's shape, capacity 8)."""
    jc, tc, jf, tf_, _ = _moe_case(arch)
    x = _x(jc, B=3, S=1, seed=7)
    want = jmoe.moe_fwd(jf, jc, jnp.asarray(x))
    got = tmoe.moe_fwd(tf_, tc, torch.from_numpy(x))
    assert_close(got, want, BLOCK_RTOL)


@pytest.mark.parametrize("arch", MOE)
def test_aux_load_balance_loss(arch):
    jc, tc, jf, tf_, x = _moe_case(arch)
    logits, _, eidx, _, _ = _jax_routing(jf, jc, jnp.asarray(x))
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits),
                                      jnp.asarray(eidx), jc.n_experts)
    got = tmoe.aux_load_balance_loss(torch.tensor(logits),
                                     torch.tensor(eidx), tc.n_experts)
    assert_close(got, want, BLOCK_RTOL)


def test_capacity_for():
    for arch in MOE + [JAMBA]:
        for full in (False, True):
            jc = jconfigs.get_config(arch, smoke=not full)
            tc = tconfigs.get_config(arch, smoke=not full)
            for n in (1, 4, 7, 64, 2000, 2048, 16000):
                assert tmoe.capacity_for(tc, n) == jmoe.capacity_for(jc, n)


def test_top_k_ties_go_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = tmoe._top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 3]]
    assert torch.equal(vals, torch.tensor(np.asarray(jv)))


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _mamba():
    jc, tc, jp, tp = _params(JAMBA)
    return jc, tc, _layer(jp["sb0"]["b0"]), _tlayer(tp["sb0"]["b0"])


def test_mamba_fwd():
    jc, tc, jb, tb = _mamba()
    x = _x(jc)
    want = jmamba.mamba_fwd(jb, jc, jnp.asarray(x))
    got = tmamba.mamba_fwd(tb, tc, torch.from_numpy(x))
    assert_close(got, want, BLOCK_RTOL)


@pytest.mark.parametrize("S", [3, 11, 16])
def test_mamba_prefill_output_and_state(S):
    """The conv window (the last ``mamba_conv - 1`` inputs) and the ssm
    state; at S = 3 the window is the whole prompt."""
    jc, tc, jb, tb = _mamba()
    x = _x(jc, S=S)
    wo, ws = jmamba.mamba_prefill(jb, jc, jnp.asarray(x))
    go, gs = tmamba.mamba_prefill(tb, tc, torch.from_numpy(x))
    assert_close(go, wo, BLOCK_RTOL)
    assert set(gs) == set(ws)
    for name in ws:
        assert_close(gs[name], ws[name], BLOCK_RTOL, name)


def test_mamba_prefill_short_prompt_keeps_the_references_short_window():
    """A prompt shorter than ``mamba_conv - 1`` gives a shorter window, in
    the reference as in the port (the engine refuses to merge it)."""
    jc, tc, jb, tb = _mamba()
    x = _x(jc, S=2)
    _, ws = jmamba.mamba_prefill(jb, jc, jnp.asarray(x))
    _, gs = tmamba.mamba_prefill(tb, tc, torch.from_numpy(x))
    assert tuple(gs["conv"].shape) == ws["conv"].shape == (2, 1, 128)


def test_mamba_step_writes_the_cache_in_place():
    jc, tc, jb, tb = _mamba()
    rng = np.random.default_rng(5)
    di, ds, _, ck = tmamba._dims(tc)
    cache = {"conv": rng.normal(size=(3, ck - 1, di)).astype(np.float32),
             "ssm": rng.normal(size=(3, di, ds)).astype(np.float32)}
    x = _x(jc, B=3, S=1, seed=6)
    wo, wc = jmamba.mamba_step(jb, jc, jnp.asarray(x),
                               {k: jnp.asarray(v) for k, v in cache.items()},
                               jnp.asarray(0))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    go, gc = tmamba.mamba_step(tb, tc, torch.from_numpy(x), tcache, 0)
    assert gc is tcache and {k: v.data_ptr() for k, v in gc.items()} == ptrs
    assert_close(go, wo, BLOCK_RTOL)
    for name in wc:
        assert_close(gc[name], wc[name], BLOCK_RTOL, name)


def test_mamba_chunked_scan_invariance():
    """Chunk size must not change the result (``tests/test_models.py``'s
    check on the port; 64 steps in 1 or 4 chunks)."""
    _, tc, _, tb = _mamba()
    x = torch.from_numpy(_x(tc, S=64, seed=3))
    y1 = tmamba.mamba_fwd(tb, tc, x, chunk=64)
    y2 = tmamba.mamba_fwd(tb, tc, x, chunk=16)
    assert_close(y2, N(y1), 2e-6)


# ---------------------------------------------------------------------------
# mLSTM and sLSTM
# ---------------------------------------------------------------------------

def _xl(bi):
    jc, tc, jp, tp = _params(XLSTM)
    return jc, tc, _layer(jp["sb0"][f"b{bi}"]), _tlayer(tp["sb0"][f"b{bi}"])


BLOCKS = {"mlstm": (0, jxlstm.mlstm_fwd, txlstm.mlstm_fwd,
                    jxlstm.mlstm_prefill, txlstm.mlstm_prefill,
                    jxlstm.mlstm_step, txlstm.mlstm_step),
          "slstm": (1, jxlstm.slstm_fwd, txlstm.slstm_fwd,
                    jxlstm.slstm_prefill, txlstm.slstm_prefill,
                    jxlstm.slstm_step, txlstm.slstm_step)}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_lstm_fwd(kind):
    bi, jf, tf_, *_ = BLOCKS[kind]
    jc, tc, jb, tb = _xl(bi)
    x = _x(jc)
    assert_close(tf_(tb, tc, torch.from_numpy(x)),
                 jf(jb, jc, jnp.asarray(x)), BLOCK_RTOL)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_lstm_prefill_output_and_state(kind):
    bi, _, _, jpre, tpre, _, _ = BLOCKS[kind]
    jc, tc, jb, tb = _xl(bi)
    x = _x(jc, S=13)
    wo, ws = jpre(jb, jc, jnp.asarray(x))
    go, gs = tpre(tb, tc, torch.from_numpy(x))
    assert_close(go, wo, BLOCK_RTOL)
    assert set(gs) == set(ws)
    for name in ws:
        assert_close(gs[name], ws[name], BLOCK_RTOL, name)


@pytest.mark.parametrize("start", ["prefilled", "empty"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_lstm_step_writes_the_cache_in_place(kind, start):
    """Two steps from a prefilled state and from the empty cache (the
    stabiliser at -1e30), outputs and every leaf."""
    bi, _, _, jpre, _, jstep, tstep = BLOCKS[kind]
    jc, tc, jb, tb = _xl(bi)
    if start == "prefilled":
        _, ws = jpre(jb, jc, jnp.asarray(_x(jc, S=9, seed=8)))
    else:
        init = (jxlstm.mlstm_init_cache if kind == "mlstm"
                else jxlstm.slstm_init_cache)
        ws = init(jc, 2, jnp.float32)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in ws.items()}
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    for step in range(2):
        x = _x(jc, S=1, seed=10 + step)
        wo, ws = jstep(jb, jc, jnp.asarray(x), ws, jnp.asarray(9 + step))
        go, gc = tstep(tb, tc, torch.from_numpy(x), tcache, 9 + step)
        assert gc is tcache
        assert {k: v.data_ptr() for k, v in gc.items()} == ptrs
        assert_close(go, wo, BLOCK_RTOL, f"step {step}")
        for name in ws:
            assert_close(gc[name], ws[name], BLOCK_RTOL, f"{step} {name}")


def test_mlstm_chunked_scan_invariance():
    """``tests/test_models.py``'s check on the port: 64 steps in 1 or 8
    chunks."""
    _, tc, _, tb = _xl(0)
    x = torch.from_numpy(_x(tc, S=64, seed=4))
    y1 = txlstm.mlstm_fwd(tb, tc, x, chunk=64)
    y2 = txlstm.mlstm_fwd(tb, tc, x, chunk=8)
    assert_close(y2, N(y1), 2e-5)


def test_mlstm_chunked_matches_the_reference_across_chunks():
    """Long sequences at the default chunk of 256: S = 300 is no multiple
    of it, so one chunk of 300 (the reference's rule); S = 512 two chunks
    of 256, the state carried between them. Over hundreds of steps the
    block at random init is ill-conditioned (outputs up to ~1e5 where the
    denominator nears zero): the reference's own output moves by more than
    1e-5 of its max when its input is perturbed by 1e-7 relative (asserted
    here), so the port is held at the whole model's ``MODEL_RTOL`` (5e-5,
    ``tests/test_torch_lm.py``)."""
    jc, tc, jb, tb = _xl(0)
    rng = np.random.default_rng(13)
    for S in (300, 512):
        x = _x(jc, B=1, S=S, seed=12, scale=0.5)
        want = np.asarray(jxlstm.mlstm_fwd(jb, jc, jnp.asarray(x)))
        moved = x * (1 + 1e-7 * rng.standard_normal(x.shape)
                     ).astype(np.float32)
        self_d = (np.abs(np.asarray(jxlstm.mlstm_fwd(
            jb, jc, jnp.asarray(moved))) - want).max() / np.abs(want).max())
        assert self_d > 1e-5, S
        got = txlstm.mlstm_fwd(tb, tc, torch.from_numpy(x))
        assert_close(got, want, MODEL_RTOL, f"S={S}")

"""The port's dense LM substrate against the JAX package, module by module:
``rms_norm``, ``rope``, the FFN and attention blocks (full sequence,
prefill with its cache, the per-slot decode step) and the whole model
(``forward``, ``prefill``, ``decode_step``), at the smoke configs of the
four dense archs, with the JAX parameters converted by
``convert.lm_params_from_jax``. Blocks in fp32 within 1e-5 of the
reference's largest magnitude. The whole model in fp32 within 5e-5: a
two-layer stack at random init amplifies ulp-level differences (exp,
rsqrt, summation order), and the reference's own logits move by more than
1e-5 of their max when its weights are perturbed by 1e-7 relative
(asserted below at yi-9b's smoke config), so 1e-5 is below what any fp32
implementation can hold. One bf16
variant of yi-9b's smoke config within 3e-2 (bf16 keeps 8 bits, and XLA
keeps some elementwise intermediates in fp32 where PyTorch rounds each
op).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.models import transformer as jtf

from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import common as tcommon
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

DENSE = ["yi-9b", "gemma-7b", "mistral-nemo-12b", "internlm2-20b"]
RTOL = {"float32": 1e-5, "bfloat16": 3e-2}
MODEL_RTOL = 5e-5          # the whole model in fp32 (module docstring)


def T(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32) if a.dtype == jnp.bfloat16
                         else np.array(a))
    return t if dtype is None else t.to(dtype)


def N(t):
    return t.detach().float().numpy()


def assert_close(got, want, rel):
    """max |got - want| <= rel * max(1e-30, max |want|), in fp32."""
    got = N(got) if isinstance(got, torch.Tensor) else np.asarray(got,
                                                                   np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    d = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert d <= rel * max(scale, 1e-30), (d, scale, d / max(scale, 1e-30))


def _cfgs(arch, dtype="float32"):
    jc = jconfigs.get_config(arch, smoke=True)
    tc = tconfigs.get_config(arch, smoke=True)
    if dtype != jc.dtype:
        jc = dataclasses.replace(jc, dtype=dtype)
        tc = dataclasses.replace(tc, dtype=dtype)
    return jc, tc


_PARAMS = {}


def _params(arch, dtype="float32"):
    """(JAX config, port config, JAX params, port params), cached."""
    key = (arch, dtype)
    if key not in _PARAMS:
        jc, tc = _cfgs(arch, dtype)
        jp = jtf.init_params(jc, jax.random.key(0))[0]
        tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                device="cpu")
        _PARAMS[key] = (jc, tc, jp, tp)
    return _PARAMS[key]


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _tlayer(tree, i=0):
    return {k: v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_are_the_references(arch, smoke):
    j = dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
    t = dataclasses.asdict(tconfigs.get_config(arch, smoke=smoke))
    assert j == t
    assert (jconfigs.embed_prefix_len(arch, 1000)
            == tconfigs.embed_prefix_len(arch, 1000))
    assert {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b",
                                  "qwen3-moe-30b-a3b", "musicgen-medium"])
def test_unported_archs_raise(arch):
    tc = tconfigs.get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        ttf.init_params(tc, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        ttf.init_decode_state(tc, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        ttf.loss_fn()


def test_lm_params_from_jax_checks_shapes():
    jc, tc, jp, _ = _params("yi-9b")
    tree = jax.tree.map(np.asarray, jp)
    tree["sb0"]["b0"]["wq"] = tree["sb0"]["b0"]["wq"][:, :, :1]
    with pytest.raises(ValueError, match="wq"):
        lm_params_from_jax(tree, tc, device="cpu")
    tree = jax.tree.map(np.asarray, jp)
    del tree["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        lm_params_from_jax(tree, tc, device="cpu")


def test_init_params_follow_the_references_distributions():
    _, tc = _cfgs("yi-9b")
    p = ttf.init_params(tc, 0, device="cpu")
    q = ttf.init_params(tc, 0, device="cpu")
    jp = jtf.init_params(_cfgs("yi-9b")[0], jax.random.key(0))[0]
    shapes = jax.tree.map(lambda a: a.shape, jp)
    got = jax.tree.map(lambda t: tuple(t.shape), p)
    assert got == shapes
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(p),
                                                 jax.tree.leaves(q)))
    assert float(p["final_norm"].abs().max()) == 0.0
    assert float(p["sb0"]["b0"]["norm"].abs().max()) == 0.0
    # normal · 0.02 for the embedding, · 1/√fan_in (fan_in = shape[-2])
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    wq = p["sb0"]["b0"]["wq"]                      # [R, dm, H, D]
    assert abs(float(wq.std()) * np.sqrt(wq.shape[-2]) - 1) < 0.05
    wo = p["sb0"]["f0"]["wo"]                      # [R, dff, dm]
    assert abs(float(wo.std()) * np.sqrt(wo.shape[-2]) - 1) < 0.05
    assert not torch.equal(p["sb0"]["b0"]["wq"][0], p["sb0"]["b0"]["wq"][1])


# ---------------------------------------------------------------------------
# shared math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 5, 64)) * 3, dtype)
    g = jnp.asarray(rng.normal(size=(64,)) * 0.1, dtype)
    want = jcommon.rms_norm(x, g, 1e-6)
    got = tcommon.rms_norm(T(x, tcommon.DTYPES[dtype]),
                           T(g, tcommon.DTYPES[dtype]), 1e-6)
    assert got.dtype == tcommon.DTYPES[dtype]
    # each op rounds once in both: bf16 equal but for an ulp
    assert_close(got, want, 1e-5 if dtype == "float32" else 8e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(dtype, theta):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 9, 3, 32)), dtype)
    pos = np.stack([np.arange(9), np.arange(9) + 100]).astype(np.int32)
    want = jcommon.rope(x, jnp.asarray(pos), theta)
    got = tcommon.rope(T(x, tcommon.DTYPES[dtype]), torch.from_numpy(pos),
                       theta)
    assert_close(got, want, RTOL[dtype])


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_act_fn_is_the_references(name):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    want = jcommon.act_fn(name)(jnp.asarray(x))
    assert_close(tcommon.act_fn(name)(torch.from_numpy(x)), want, 1e-6)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _x(cfg, B=2, S=11, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return x, np.ascontiguousarray(pos)


@pytest.mark.parametrize("arch", DENSE)
def test_ffn_fwd(arch):
    jc, tc, jp, tp = _params(arch)
    x, _ = _x(jc)
    want = jlayers.ffn_fwd(_layer(jp["sb0"]["f0"]), jc, jnp.asarray(x))
    got = tlayers.ffn_fwd(_tlayer(tp["sb0"]["f0"]), tc, torch.from_numpy(x))
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_attn_fwd(arch):
    jc, tc, jp, tp = _params(arch)
    x, pos = _x(jc)
    want = jlayers.attn_fwd(_layer(jp["sb0"]["b0"], 1), jc, jnp.asarray(x),
                            jnp.asarray(pos))
    got = tlayers.attn_fwd(_tlayer(tp["sb0"]["b0"], 1), tc,
                           torch.from_numpy(x), torch.from_numpy(pos))
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_attn_prefill_output_and_cache(arch):
    jc, tc, jp, tp = _params(arch)
    x, pos = _x(jc, S=13)
    wo, wc = jlayers.attn_prefill(_layer(jp["sb0"]["b0"]), jc, jnp.asarray(x),
                                  jnp.asarray(pos), 20)
    go, gc = tlayers.attn_prefill(_tlayer(tp["sb0"]["b0"]), tc,
                                  torch.from_numpy(x), torch.from_numpy(pos),
                                  20)
    assert_close(go, wo, 1e-5)
    for name in ("k", "v"):
        assert_close(gc[name], wc[name], 1e-5)
        assert float(gc[name][:, 13:].abs().max()) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_attn_step_per_slot_positions(arch):
    jc, tc, jp, tp = _params(arch)
    rng = np.random.default_rng(3)
    B, L = 3, 16
    shape = (B, L, jc.n_kv, jc.head_dim)
    cache = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    x = rng.normal(size=(B, 1, jc.d_model)).astype(np.float32)
    pos = np.array([5, 0, 15], np.int32)
    wo, wc = jlayers.attn_step(_layer(jp["sb0"]["b0"]), jc, jnp.asarray(x),
                               {n: jnp.asarray(c) for n, c in cache.items()},
                               jnp.asarray(pos))
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    go, gc = tlayers.attn_step(_tlayer(tp["sb0"]["b0"]), tc,
                               torch.from_numpy(x), tcache,
                               torch.from_numpy(pos))
    assert gc is tcache                               # written in place
    assert_close(go, wo, 1e-5)
    for n in "kv":
        assert_close(gc[n], wc[n], 1e-5)


def test_attn_step_scalar_position():
    jc, tc, jp, tp = _params("yi-9b")
    rng = np.random.default_rng(4)
    shape = (2, 12, jc.n_kv, jc.head_dim)
    cache = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    x = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
    wo, wc = jlayers.attn_step(_layer(jp["sb0"]["b0"]), jc, jnp.asarray(x),
                               {n: jnp.asarray(c) for n, c in cache.items()},
                               jnp.asarray(7, jnp.int32))
    go, gc = tlayers.attn_step(_tlayer(tp["sb0"]["b0"]), tc,
                               torch.from_numpy(x),
                               {n: torch.from_numpy(c.copy())
                                for n, c in cache.items()}, 7)
    assert_close(go, wo, 1e-5)
    for n in "kv":
        assert_close(gc[n], wc[n], 1e-5)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _tokens(cfg, B=2, S=10, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward(arch):
    jc, tc, jp, tp = _params(arch)
    tok = _tokens(jc)
    want = jtf.forward(jp, jc, {"tokens": jnp.asarray(tok)})
    got = ttf.forward(tp, tc, {"tokens": torch.from_numpy(tok)})
    assert_close(got, want, MODEL_RTOL)


def _serve_both(arch, dtype="float32", S=10, L=24):
    """Prefill a batch of 2 prompts, then two per-slot decode steps, in
    both packages; yields (label, port result, JAX result)."""
    jc, tc, jp, tp = _params(arch, dtype)
    tok = _tokens(jc, S=S)
    wl, ws = jtf.prefill(jp, jc, {"tokens": jnp.asarray(tok)}, L)
    gl, gs = ttf.prefill(tp, tc, {"tokens": torch.from_numpy(tok)}, L)
    yield "prefill logits", gl, wl
    for name in ("k", "v"):
        yield f"prefill cache {name}", gs["sb0"]["b0"][name], \
            ws["sb0"]["b0"][name]
    rng = np.random.default_rng(6)
    for step, pos in enumerate((np.array([S, S - 3], np.int32),
                                np.array([S + 1, S - 2], np.int32))):
        nxt = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
        wl, ws = jtf.decode_step(jp, jc, ws, {"tokens": jnp.asarray(nxt)},
                                 jnp.asarray(pos))
        gl, gs2 = ttf.decode_step(tp, tc, gs, {"tokens": torch.from_numpy(nxt)},
                                  torch.from_numpy(pos))
        assert gs2 is gs
        yield f"decode {step} logits", gl, wl
        for name in ("k", "v"):
            yield f"decode {step} cache {name}", gs["sb0"]["b0"][name], \
                ws["sb0"]["b0"][name]


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_step(arch):
    for label, got, want in _serve_both(arch):
        assert_close(got, want, MODEL_RTOL)


def test_forward_prefill_decode_bf16():
    jc, tc, jp, tp = _params("yi-9b", "bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    tok = _tokens(jc)
    want = jtf.forward(jp, jc, {"tokens": jnp.asarray(tok)})
    got = ttf.forward(tp, tc, {"tokens": torch.from_numpy(tok)})
    assert got.dtype == torch.bfloat16
    assert_close(got, want, RTOL["bfloat16"])
    for label, got, want in _serve_both("yi-9b", "bfloat16"):
        assert_close(got, want, RTOL["bfloat16"])


@pytest.mark.parametrize("arch", ["yi-9b", "gemma-7b"])
def test_prefill_logits_equal_forward_last_position(arch):
    _, tc, _, tp = _params(arch)
    tok = torch.from_numpy(_tokens(tc, S=9))
    full = ttf.forward(tp, tc, {"tokens": tok})
    last, _ = ttf.prefill(tp, tc, {"tokens": tok}, 16)
    assert_close(last, N(full[:, -1:]), 1e-5)


def test_whole_model_tolerance_against_the_references_sensitivity():
    """Why the whole model is held at MODEL_RTOL and not 1e-5: perturbing
    the reference's weights by 1e-7 relative (about one fp32 ulp) moves its
    own logits by more than 1e-5 of their max; the port stays within
    MODEL_RTOL of it."""
    jc, tc, jp, tp = _params("yi-9b")
    tok = _tokens(jc)
    want = np.asarray(jtf.forward(jp, jc, {"tokens": jnp.asarray(tok)}))
    rng = np.random.default_rng(9)
    moved = jax.tree.map(lambda a: a * (1 + 1e-7 * jnp.asarray(
        rng.standard_normal(a.shape), a.dtype)), jp)
    self_d = np.abs(np.asarray(jtf.forward(moved, jc, {"tokens": jnp.asarray(
        tok)})) - want).max() / np.abs(want).max()
    assert self_d > 1e-5
    assert_close(ttf.forward(tp, tc, {"tokens": torch.from_numpy(tok)}),
                 want, MODEL_RTOL)

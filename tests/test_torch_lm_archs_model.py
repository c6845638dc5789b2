"""The port's whole LM against the JAX package for every architecture the
reference configures beyond the dense four (``tests/test_torch_lm.py``):
qwen3-moe and kimi-k2 (MoE FFNs), jamba (Mamba, attention, dense and MoE
FFNs), xlstm (mLSTM and sLSTM), musicgen (frame embeddings as the only
input) and pixtral (patch embeddings as a prefix of the tokens), at their
fp32 smoke configs with converted parameters: ``forward``, ``prefill``
(logits and every state leaf) and two per-slot ``decode_step``s (logits
and every leaf, written in place), and prefill logits equal to forward's
last position (the slot engine on these archs:
``tests/test_torch_lm_archs_serve.py``). The whole model within
``5e-5 * max|ref|``, the tolerance
``tests/test_torch_lm.py`` justifies by the reference's own sensitivity;
a state leaf within that or, where more, the reference's own movement
under a 1e-7 weight perturbation (the sLSTM state's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf

from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

MODEL_RTOL = 5e-5
ARCHS = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b",
         "xlstm-350m", "musicgen-medium", "pixtral-12b"]


def N(t):
    return t.detach().float().numpy()


def assert_close(got, want, rel, what=""):
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


def _params(arch):
    if arch not in _PARAMS:
        jc = jconfigs.get_config(arch, smoke=True)
        tc = tconfigs.get_config(arch, smoke=True)
        jp = jtf.init_params(jc, jax.random.key(0))[0]
        tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                device="cpu")
        _PARAMS[arch] = (jc, tc, jp, tp)
    return _PARAMS[arch]


def _batch(arch, cfg, S=10, seed=5):
    """numpy inputs of S positions: tokens; frame embeddings (musicgen);
    an image prefix of ``configs.embed_prefix_len`` patch embeddings and
    the rest tokens (pixtral)."""
    rng = np.random.default_rng(seed)
    n_img = tconfigs.embed_prefix_len(arch, S)
    batch = {}
    if cfg.embedding_inputs or n_img:
        n = S if cfg.embedding_inputs else n_img
        batch["embeds"] = rng.normal(size=(2, n, cfg.d_model)).astype(
            np.float32)
    if not cfg.embedding_inputs:
        batch["tokens"] = rng.integers(0, cfg.vocab,
                                       (2, S - n_img)).astype(np.int32)
    return batch


def _step_input(cfg, rng):
    if cfg.embedding_inputs:
        return {"embeds": rng.normal(size=(2, 1, cfg.d_model)).astype(
            np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaves(state):
    for sk, blocks in state.items():
        for bk, leaves in blocks.items():
            for name, leaf in leaves.items():
                yield f"{sk}/{bk}/{name}", leaf


@pytest.mark.parametrize("arch", ARCHS)
def test_forward(arch):
    jc, tc, jp, tp = _params(arch)
    b = _batch(arch, jc)
    want = jtf.forward(jp, jc, _jb(b))
    got = ttf.forward(tp, tc, _tb(b))
    assert got.shape[1] == 10
    assert_close(got, want, MODEL_RTOL)


POSITIONS = (np.array([10, 7], np.int32), np.array([11, 8], np.int32))


def _jax_serve(jp, jc, b, L):
    """The reference's prefill and two decode steps at ``POSITIONS``:
    [(logits, {leaf path: leaf})] for each of the three calls."""
    wl, ws = jtf.prefill(jp, jc, _jb(b), L)
    out = [(np.asarray(wl), dict(_leaves(ws)))]
    rng = np.random.default_rng(6)
    for pos in POSITIONS:
        wl, ws = jtf.decode_step(jp, jc, ws, _jb(_step_input(jc, rng)),
                                 jnp.asarray(pos))
        out.append((np.asarray(wl), dict(_leaves(ws))))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps(arch):
    """Prefill a batch of 2 prompts of 10 positions, then two decode steps
    at per-slot positions: logits within ``MODEL_RTOL``, and every state
    leaf (KV caches, conv windows, ssm, C/n/m, c/n/h/m), each step writing
    the port's state in place. A leaf is held within ``MODEL_RTOL`` or,
    where more, the reference's own sensitivity: how far the same leaf
    moves when the reference's weights are perturbed by 1e-7 relative
    (about one fp32 ulp). The sLSTM's state is that ill-conditioned at
    random init (the reference moves it by ~3e-4 of its max; the port
    stays within ~8e-5)."""
    jc, tc, jp, tp = _params(arch)
    b = _batch(arch, jc, S=10)
    want = _jax_serve(jp, jc, b, 24)
    rng = np.random.default_rng(9)
    moved = _jax_serve(jax.tree.map(lambda a: a * (1 + 1e-7 * jnp.asarray(
        rng.standard_normal(a.shape), a.dtype)), jp), jc, b, 24)
    gl, gs = ttf.prefill(tp, tc, _tb(b), 24)
    got = [(gl, {n: t.clone() for n, t in _leaves(gs)})]
    ptrs = {name: t.data_ptr() for name, t in _leaves(gs)}
    rng = np.random.default_rng(6)
    for pos in POSITIONS:
        gl, gs2 = ttf.decode_step(tp, tc, gs, _tb(_step_input(jc, rng)),
                                  torch.from_numpy(pos))
        assert gs2 is gs
        assert {n: t.data_ptr() for n, t in _leaves(gs)} == ptrs
        got.append((gl, {n: t.clone() for n, t in _leaves(gs)}))
    for call, ((g_l, g_s), (w_l, w_s), (_, m_s)) in enumerate(
            zip(got, want, moved)):
        assert_close(g_l, w_l, MODEL_RTOL, f"call {call} logits")
        assert set(g_s) == set(w_s)
        for name, leaf in g_s.items():
            tol = max(MODEL_RTOL, _rel(m_s[name], w_s[name]))
            assert_close(leaf, w_s[name], tol, f"call {call} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_equal_forward_last_position(arch):
    _, tc, _, tp = _params(arch)
    b = _tb(_batch(arch, tc, S=12, seed=9))
    full = ttf.forward(tp, tc, b)
    last, _ = ttf.prefill(tp, tc, b, 16)
    assert_close(last, N(full[:, -1:]), 1e-5)

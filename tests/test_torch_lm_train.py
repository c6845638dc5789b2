"""The port's LM loss and its gradients against the JAX package, at every
architecture's fp32 smoke config with converted parameters:
``transformer.loss_fn`` and the gradient of every leaf (the training
step's per-layer leaves, ``train.loop.step_leaves``, stacked back) against
``jax.value_and_grad(repro.models.transformer.loss_fn)``; ``remat=True``
bitwise equal to ``remat=False``; label masking and the token-suffix loss
with an embedding prefix; ``common.cross_entropy``; and the attention's
plain backward (``flash_attention_bwd_torch``) against ``jax.grad`` of the
reference's ``grouped_attention``.

The dense archs, pixtral and musicgen here; MoE and xLSTM in
``tests/test_torch_lm_train_archs.py``, jamba in
``tests/test_torch_lm_train_jamba.py`` (both import this module's
helpers). Gates: the loss within ``5e-5`` relative; every gradient leaf
within ``5e-5 * max|ref|`` of the reference's (the whole-model tolerance
of ``tests/test_torch_lm.py``) or, where a leaf misses that, within
``8x`` the reference's own fp32 error: its distance from the same
gradient evaluated in float64. Smoke-sized models at random init have gradients that fp32
computes only to ~1e-4 (jamba's Mamba leaves: the reference itself is
9e-5 off float64, and the 1e-7 weight perturbation of
``tests/test_torch_lm_archs_model.py`` moves them by less than that), and
the port's reductions and its sequential scan round in another order than
XLA's fused ones and associative scan: measured at up to 4.4x the
reference's own fp32 error against float64 over the ten archs. The
xLSTM's mLSTM input-gate bias has an exact gradient of 0 (the stabilised
mLSTM is invariant under a shift of its input gates): both fp32 values
are rounding noise, held by the same rule.
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
from repro_torch.kernels.flash_attention import (flash_attention_bwd_torch,
                                                 flash_attention_torch)
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.train.loop import step_leaves

torch.set_num_threads(1)

RTOL = 5e-5
F32_FACTOR = 8          # times the reference's own fp32 error (module doc)
ARCHS = ["gemma-7b", "internlm2-20b", "mistral-nemo-12b", "musicgen-medium",
         "pixtral-12b", "yi-9b"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _paths(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jc = jconfigs.get_config(arch, smoke=True)
        tc = tconfigs.get_config(arch, smoke=True)
        jp = jax.jit(lambda key: jtf.init_params(jc, key)[0])(
            jax.random.key(0))
        tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                device="cpu")
        _PARAMS[arch] = (jc, tc, jp, tp)
    return _PARAMS[arch]


_GRAD = {}


def _batch(arch, cfg, S=12, seed=5, masked=3):
    """numpy inputs of S positions and their labels (``masked`` of them
    -1): tokens; frame embeddings only (musicgen); an image prefix of patch
    embeddings and the rest tokens (pixtral), labels for the tokens."""
    rng = np.random.default_rng(seed)
    n_img = tconfigs.embed_prefix_len(arch, S)
    batch = {}
    if cfg.embedding_inputs or n_img:
        n = S if cfg.embedding_inputs else n_img
        batch["embeds"] = rng.normal(size=(2, n, cfg.d_model)).astype(
            np.float32)
    n_lab = S if cfg.embedding_inputs else S - n_img
    if not cfg.embedding_inputs:
        batch["tokens"] = rng.integers(0, cfg.vocab, (2, n_lab)).astype(
            np.int32)
    labels = rng.integers(0, cfg.vocab, (2, n_lab)).astype(np.int32)
    labels.reshape(-1)[rng.choice(labels.size, masked, replace=False)] = -1
    batch["labels"] = labels
    return batch


def _jax_value_and_grad(jp, jc, b, x64=False):
    """The reference's loss and gradient leaves by path, in fp32 or (for
    its own rounding error) with parameters and embeddings in float64."""
    with jax.enable_x64(x64):
        if x64:
            jc = dataclasses.replace(jc, dtype="float64")
            jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
        key = (jc.name, x64)
        if key not in _GRAD:
            _GRAD[key] = jax.jit(jax.value_and_grad(
                lambda p, b_: jtf.loss_fn(p, jc, b_)))
        loss, g = _GRAD[key](jp, {k: jnp.asarray(
            v, jnp.float64 if x64 and v.dtype == np.float32 else v.dtype)
            for k, v in b.items()})
        return float(loss), dict(_paths(jax.tree.map(np.asarray, g)))


def _port_value_and_grad(tp, tc, b, remat=False):
    tree, entries = step_leaves(tp)
    flat = [x for _, leaf in entries
            for x in (leaf if isinstance(leaf, tuple) else (leaf,))]
    loss = ttf.loss_fn(tree, tc, {k: torch.from_numpy(v)
                                  for k, v in b.items()}, remat=remat)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    out, at = {}, 0
    for path, leaf in entries:
        n = len(leaf) if isinstance(leaf, tuple) else 1
        g = grads[at:at + n]
        out[path] = torch.stack(g) if isinstance(leaf, tuple) else g[0]
        at += n
    return loss, out


def check_loss_and_gradients(arch):
    """The loss and every leaf's gradient against the reference's (module
    doc)."""
    jc, tc, jp, tp = _params(arch)
    b = _batch(arch, jc)
    want_loss, want = _jax_value_and_grad(jp, jc, b)
    loss, got = _port_value_and_grad(tp, tc, b)
    assert abs(float(loss.detach()) - want_loss) <= RTOL * abs(want_loss)
    assert set(got) == set(want)
    exact = None                     # the float64 gradient, where needed
    for path, g in got.items():
        gn, w = g.numpy(), want[path]
        assert gn.shape == w.shape, path
        assert np.isfinite(gn).all(), path
        err = float(np.abs(gn - w).max())
        if err <= RTOL * float(np.abs(w).max()):
            continue
        if exact is None:
            exact = _jax_value_and_grad(jp, jc, b, x64=True)[1]
        own = float(np.abs(w - exact[path]).max())
        assert err <= F32_FACTOR * own, (path, err, own)


def check_remat_is_bitwise(arch):
    _, tc, _, tp = _params(arch)
    b = _batch(arch, tc, seed=7)
    l0, g0 = _port_value_and_grad(tp, tc, b, remat=False)
    l1, g1 = _port_value_and_grad(tp, tc, b, remat=True)
    assert torch.equal(l0, l1)
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_leaf_gradient(arch):
    check_loss_and_gradients(arch)


def test_remat_is_bitwise():
    check_remat_is_bitwise("yi-9b")


def test_label_masking():
    """Labels < 0 drop out of the sum and the count: the loss of a batch
    with masked labels equals the mean over the kept positions, and a
    batch with every label masked gives 0 (the count clamped to 1)."""
    jc, tc, jp, tp = _params("yi-9b")
    b = _batch("yi-9b", tc, masked=5)
    logits = ttf.forward(tp, tc, {"tokens": torch.from_numpy(b["tokens"])})
    lab = torch.from_numpy(b["labels"])
    keep = lab >= 0
    want = tcommon.cross_entropy(logits[keep], lab[keep])
    got = ttf.loss_fn(tp, tc, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert abs(float(got) - float(jtf.loss_fn(
        jp, jc, {k: jnp.asarray(v) for k, v in b.items()}))) \
        <= RTOL * abs(float(got))
    none = dict(b, labels=np.full_like(b["labels"], -1))
    assert float(ttf.loss_fn(tp, tc, {k: torch.from_numpy(v)
                                      for k, v in none.items()})) == 0.0


def test_vlm_embeds_prefix_loss():
    """``tests/test_models.py::test_vlm_embeds_prefix_loss`` on the port:
    an image prefix of Si embeddings and St tokens; logits cover all Si +
    St positions, the loss only the token suffix (equal to the
    reference's)."""
    cfg = tcommon.dense_lm("tinyvlm", n_layers=2, d_model=64, n_heads=4,
                           n_kv=2, d_ff=128, vocab=128, dtype="float32")
    jcfg = jcommon.dense_lm("tinyvlm", n_layers=2, d_model=64, n_heads=4,
                            n_kv=2, d_ff=128, vocab=128, dtype="float32")
    jp = jtf.init_params(jcfg, jax.random.key(0))[0]
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    B, Si, St = 2, 8, 16
    rng = np.random.default_rng(5)
    b = {"embeds": rng.normal(size=(B, Si, cfg.d_model)).astype(np.float32),
         "tokens": rng.integers(0, cfg.vocab, (B, St)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, St)).astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = ttf.loss_fn(tp, cfg, tb)
    assert np.isfinite(float(loss))
    logits = ttf.forward(tp, cfg, tb)
    assert logits.shape == (B, Si + St, cfg.vocab)
    suffix = tcommon.cross_entropy(logits[:, Si:], tb["labels"])
    assert abs(float(loss) - float(suffix)) <= 1e-6 * float(suffix)
    want = float(jtf.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                        for k, v in b.items()}))
    assert abs(float(loss) - want) <= RTOL * want


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    want = float(jcommon.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels)))
    got = float(tcommon.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


# (D, (B, Sq, Skv, H, KV)): GQA 4 query heads per KV head at every head
# dim, then the edge shapes of the card's backward kernels: Sq < Skv with
# neither a multiple of 64 (a key tile across the diagonal at offset 70),
# G = 1 and G = 8
BWD_CASES = ([pytest.param(D, (2, 37, 37, 8, 2), id=str(D))
              for D in (64, 128, 256)]
             + [pytest.param(64, (1, 130, 200, 4, 2), id="64-sq130-skv200"),
                pytest.param(64, (2, 45, 45, 4, 4), id="64-G1"),
                pytest.param(64, (1, 45, 45, 8, 1), id="64-G8")])


@pytest.mark.parametrize("D,shape", BWD_CASES)
def test_plain_backward_matches_jax_grad(D, shape):
    """The attention's closed-form backward against ``jax.grad`` of the
    reference's ``grouped_attention`` (causal, ragged S; for Sq < Skv the
    reference is called at ``q_offset = Skv - Sq``, the port's end-aligned
    diagonal): dQ, dK, dV within 5e-5 of their max (the reference's q is
    scaled inside; the port's plain backward takes the scaled q with scale
    1 and the chain rule outside, as the model calls it)."""
    B, Sq, Skv, H, KV = shape
    rng = np.random.default_rng(D + Sq + H)
    q, k, v, do = (rng.normal(size=sh).astype(np.float32)
                   for sh in ((B, Sq, H, D), (B, Skv, KV, D),
                              (B, Skv, KV, D), (B, Sq, H, D)))

    def ref(q, k, v):
        o = jlayers.grouped_attention(q, k, v, causal=True,
                                      q_offset=Skv - Sq, kv_chunk=16)
        return jnp.sum(o * do)

    wq, wk, wv = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    c = np.float32(1.0 / np.sqrt(D))
    tq = torch.from_numpy(q) * torch.tensor(c)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    out = flash_attention_torch(tq, tk, tv, causal=True, scale=1.0)
    dq, dk, dv = flash_attention_bwd_torch(tq, tk, tv, out,
                                           torch.from_numpy(do),
                                           causal=True, scale=1.0)
    for got, want in ((dq * c, wq), (dk, wk), (dv, wv)):
        assert _rel(got.numpy(), np.asarray(want)) <= RTOL


def test_plain_backward_is_autograd_of_plain_forward():
    """The closed form against autograd through ``flash_attention_torch``
    (fp32, causal and full, Sq < Skv, scale != 1)."""
    g = torch.Generator().manual_seed(0)
    for causal in (True, False):
        q = torch.randn((2, 7, 4, 64), generator=g, requires_grad=True)
        k = torch.randn((2, 9, 2, 64), generator=g, requires_grad=True)
        v = torch.randn((2, 9, 2, 64), generator=g, requires_grad=True)
        o = flash_attention_torch(q, k, v, causal=causal, scale=0.3,
                                  kv_chunk=3)
        do = torch.randn(o.shape, generator=g)
        want = torch.autograd.grad(o, (q, k, v), do)
        got = flash_attention_bwd_torch(q.detach(), k.detach(), v.detach(),
                                        o.detach(), do, causal=causal,
                                        scale=0.3)
        for a, b in zip(got, want):
            assert _rel(a.numpy(), b.numpy()) <= 1e-5

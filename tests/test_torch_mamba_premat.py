"""``REPRO_MAMBA_PREMAT=1`` on the port against the reference under the
same variable, and against the port's own chunked scan.

The switch discretises the whole sequence up front (``dA`` and ``dBx`` as
``[B, S, d_inner, d_state]``) instead of chunk by chunk; the reference
reads it when it traces ``mamba_fwd``, the port at each call. Each test
sets it with ``monkeypatch.setenv`` and traces its own JAX functions, so no
trace made without it is reused.

- The Mamba block at the jamba smoke config, 16 positions in chunks of 4:
  output and prefill state against the reference's premat block, at the
  block tolerance of ``tests/test_torch_lm_archs.py``.
- The jamba smoke model's loss and every leaf's gradient against
  ``jax.value_and_grad`` of the reference's premat ``loss_fn``, gated as
  ``tests/test_torch_lm_train.py`` gates them (the loss within 5e-5
  relative; a leaf within 5e-5 of its max or 8x the reference's own fp32
  error against its float64 evaluation).
- Premat against chunked in the port: the forward and the last state are
  bitwise equal on the CPU (the same elementwise operations on the same
  rows); the gradients are not, as the full-sequence product's backward
  sums over the sequence in one reduction where the chunked one adds the
  chunks' gradients in turn: measured within 2.1e-7 of each leaf's max,
  gated at ``PREMAT_GRAD_RTOL = 2e-6``. On the card the full-sequence
  ``x_proj`` product can take another cuBLAS kernel than the per-chunk
  ones, so chip_smoke's 12b A/B (the bf16 jamba cut) holds the premat
  logits within 2e-2 of max|logits| of the default's, the bf16 kernels'
  gate (``PREMAT_GATE``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import mamba as jmamba
from repro.models import transformer as jtf
from repro_torch.models import mamba as tmamba

from test_torch_lm_archs import (BLOCK_RTOL, N, _layer, _tlayer, _x,
                                 assert_close)
from test_torch_lm_train import (F32_FACTOR, RTOL, _batch, _paths,
                                 _port_value_and_grad)
from test_torch_lm_train import _params as _model_params

ARCH = "jamba-1.5-large-398b"
PREMAT_GRAD_RTOL = 2e-6


def _premat(monkeypatch):
    monkeypatch.setenv("REPRO_MAMBA_PREMAT", "1")


def _mamba():
    """The first Mamba block of the jamba smoke model (both packages'
    parameters, shared with the whole-model test)."""
    jc, tc, jp, tp = _model_params(ARCH)
    return jc, tc, _layer(jp["sb0"]["b0"]), _tlayer(tp["sb0"]["b0"])


def test_premat_block_matches_the_references_premat_block(monkeypatch):
    _premat(monkeypatch)
    jc, tc, jb, tb = _mamba()
    x = _x(jc, S=16, seed=3)
    wo, ws = jmamba.mamba_fwd(jb, jc, jnp.asarray(x), chunk=4,
                              return_state=True)
    go, gs = tmamba.mamba_fwd(tb, tc, torch.from_numpy(x), chunk=4,
                              return_state=True)
    assert_close(go, wo, BLOCK_RTOL)
    for name in ws:
        assert_close(gs[name], ws[name], BLOCK_RTOL, name)


def _jax_premat_value_and_grad(jp, jc, b, x64=False):
    """The reference's premat loss and gradient leaves, traced here (under
    the variable), in fp32 or with parameters and embeddings in float64."""
    with jax.enable_x64(x64):
        if x64:
            jc = dataclasses.replace(jc, dtype="float64")
            jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b_: jtf.loss_fn(p, jc, b_)))
        loss, g = fn(jp, {k: jnp.asarray(
            v, jnp.float64 if x64 and v.dtype == np.float32 else v.dtype)
            for k, v in b.items()})
        return float(loss), dict(_paths(jax.tree.map(np.asarray, g)))


def test_premat_loss_and_every_leaf_gradient(monkeypatch):
    _premat(monkeypatch)
    jc, tc, jp, tp = _model_params(ARCH)
    b = _batch(ARCH, jc)
    want_loss, want = _jax_premat_value_and_grad(jp, jc, b)
    loss, got = _port_value_and_grad(tp, tc, b)
    assert abs(float(loss.detach()) - want_loss) <= RTOL * abs(want_loss)
    assert set(got) == set(want)
    exact = None
    for path, g in got.items():
        gn, w = g.numpy(), want[path]
        assert gn.shape == w.shape and np.isfinite(gn).all(), path
        err = float(np.abs(gn - w).max())
        if err <= RTOL * float(np.abs(w).max()):
            continue
        if exact is None:
            exact = _jax_premat_value_and_grad(jp, jc, b, x64=True)[1]
        own = float(np.abs(w - exact[path]).max())
        assert err <= F32_FACTOR * own, (path, err, own)


def _block_run(tb, tc):
    """Output, last state and the gradients of a scalar of both with
    respect to the input and every float leaf, 16 positions in chunks of
    4."""
    p = {k: v.detach().clone().requires_grad_(v.is_floating_point())
         for k, v in tb.items()}
    x = torch.from_numpy(_x(tc, S=16, seed=3)).requires_grad_(True)
    y, st = tmamba.mamba_fwd(p, tc, x, chunk=4, return_state=True)
    leaves = [x] + [v for v in p.values() if v.requires_grad]
    grads = torch.autograd.grad((y ** 2).sum() + st["ssm"].sum(), leaves,
                                allow_unused=True, materialize_grads=True)
    return y.detach(), st["ssm"].detach(), grads


def test_premat_against_the_chunked_scan(monkeypatch):
    _, tc, _, tb = _mamba()
    monkeypatch.delenv("REPRO_MAMBA_PREMAT", raising=False)
    y0, s0, g0 = _block_run(tb, tc)
    monkeypatch.setenv("REPRO_MAMBA_PREMAT", "0")     # only "1" switches
    y1, s1, g1 = _block_run(tb, tc)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    _premat(monkeypatch)
    y2, s2, g2 = _block_run(tb, tc)
    assert torch.equal(y0, y2) and torch.equal(s0, s2)
    for i, (a, b) in enumerate(zip(g0, g2)):
        assert_close(b, N(a), PREMAT_GRAD_RTOL, f"gradient {i}")

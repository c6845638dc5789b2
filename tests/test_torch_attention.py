"""The flash attention kernel's plain version against the JAX package: the
Pallas kernel run in interpret mode and ``flash_attention_ref``, at small
shapes of the JAX kernel sweep, the cross-length case, ragged lengths,
fully masked rows, GQA by index, and both scale conventions (``1/√D``
after the dot in ``ops.attention``; q pre-scaled with scale 1 in
``grouped_attention``). fp32 within ``rtol = atol = 1e-5``, bf16 within
``2e-2`` (the JAX kernel tests' tolerances). On the CPU the wrappers run
the plain version; the CUDA wrapper refuses a CPU tensor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as jlayers

from repro_torch.kernels import LAUNCHERS, ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_torch)
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(shape_q, shape_k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in (shape_q, shape_k, shape_k)]
    j = [jnp.asarray(a, dtype) for a in arrs]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(TDT[dtype])
         for a in j]
    return j, t


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("BH,S,D,causal", [
    (2, 128, 64, True),
    (2, 128, 64, False),
    (1, 256, 128, True),
    (2, 128, 256, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_ref(BH, S, D, causal, dtype):
    (jq, jk, jv), (q, k, v) = _qkv((BH, S, D), (BH, S, D), dtype)
    got = ops.attention(q, k, v, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (BH, S, D)
    pallas = jflash(jq, jk, jv, causal=causal, interpret=True)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    for w in (pallas, want):
        np.testing.assert_allclose(_np(got), np.asarray(w, np.float32),
                                   **TOLS[dtype])


def test_cross_length_end_aligned_diagonal():
    """Sq < Skv: the causal diagonal sits at the end of the keys."""
    (jq, jk, jv), (q, k, v) = _qkv((2, 128, 64), (2, 512, 64), "float32", 1)
    got = _np(ops.attention(q, k, v, causal=True))
    for w in (jflash(jq, jk, jv, causal=True, interpret=True),
              jref.flash_attention_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Sq,Skv", [(100, 100), (37, 150), (1, 70),
                                    (130, 61)])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_lengths_and_fully_masked_rows(Sq, Skv, causal):
    """Lengths that no 64- or 128-row tile divides; with Sq > Skv under
    ``causal`` the first rows see no key and average V over all of them,
    as the reference's softmax over -1e30 does (never NaN)."""
    (jq, jk, jv), (q, k, v) = _qkv((2, Sq, 64), (2, Skv, 64), "float32", 2)
    got = _np(ops.attention(q, k, v, causal=causal))
    want = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if causal and Sq > Skv:
        np.testing.assert_allclose(got[:, 0], _np(v).mean(1), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("H,KV", [(4, 2), (8, 1), (4, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_by_index(H, KV, dtype):
    """Query head h reads KV head h // (H // KV): the reference's repeat
    of the KV heads, without materialising it."""
    B, S, D = 2, 50, 64
    (_, jk, jv), (q, k, v) = _qkv((B, S, H, D), (B, S, KV, D), dtype, 3)
    jq = jnp.asarray(_np(q), dtype)
    got = flash_attention_torch(q, k, v, causal=True, scale=D ** -0.5)
    rep = lambda a: jnp.repeat(a, H // KV, axis=2)       # noqa: E731
    fold = lambda a: a.transpose(0, 2, 1, 3).reshape(B * a.shape[2], S, D)  # noqa: E731
    want = jref.flash_attention_ref(fold(jq), fold(rep(jk)), fold(rep(jv)),
                                    causal=True)
    want = np.asarray(want, np.float32).reshape(B, H, S, D).transpose(
        0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), want, **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,kv_chunk", [(40, 1024), (64, 16), (48, 20)])
def test_grouped_attention_prescaled_q(dtype, S, kv_chunk):
    """``grouped_attention``'s convention: q scaled in its own dtype first
    (the scale rounded to it), then scale 1 — against the JAX chunked
    attention, chunked or not."""
    B, H, KV, D = 2, 4, 2, 128
    (jq, jk, jv), (q, k, v) = _qkv((B, S, H, D), (B, S, KV, D), dtype, 4)
    want = jlayers.grouped_attention(jq, jk, jv, causal=True,
                                     kv_chunk=kv_chunk)
    got = tlayers.grouped_attention(q, k, v, causal=True, kv_chunk=kv_chunk)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOLS[dtype])


def test_grouped_attention_decode_masks_per_slot():
    """The decode call (``causal=False``, per-slot ``kv_len`` over a padded
    cache) against the JAX function: the plain math on every device."""
    B, H, KV, D, L = 3, 4, 2, 64, 32
    (jq, jk, jv), (q, k, v) = _qkv((B, 1, H, D), (B, L, KV, D), "float32", 5)
    kv_len = np.array([1, 17, 32], np.int32)
    want = jlayers.grouped_attention(jq, jk, jv, causal=False,
                                     kv_len=jnp.asarray(kv_len), kv_chunk=L)
    got = tlayers.grouped_attention(q, k, v, causal=False,
                                    kv_len=torch.from_numpy(kv_len),
                                    kv_chunk=L)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    _, (q, k, v) = _qkv((1, 8, 1, 64), (1, 8, 1, 64), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, causal=True, scale=0.125)
    with pytest.raises(ValueError, match="cuda"):
        ops.attention(q[:, :, 0], k[:, :, 0], v[:, :, 0], backend="cuda")
    assert LAUNCHERS["flash_attention"] is flash_attention
    assert flash_attention.launches == 0


@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_check_plain_version(D):
    """The wgmma helpers' check on CPU tensors runs its plain version:
    x = a . b^T and y = bf16(x) . v in fp32 (the products the bf16
    backward kernels run), and it refuses a head dim the kernels do not
    take."""
    from repro_torch.kernels.flash_attention import wgmma_check
    g = torch.Generator().manual_seed(D)
    a, b, v = (torch.randn((64, D), generator=g).to(torch.bfloat16)
               for _ in range(3))
    x, y = wgmma_check(a, b, v)
    want = a.double() @ b.double().T
    assert x.dtype == torch.float32 and x.shape == (64, 64)
    assert float((x.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    want_y = x.to(torch.bfloat16).double() @ v.double()
    assert y.shape == (64, D)
    assert float((y.double() - want_y).abs().max()) <= 1e-5 * float(
        want_y.abs().max())
    with pytest.raises(ValueError, match="D in"):
        wgmma_check(a[:, :32], b[:, :32], v[:, :32])

"""Card-only tests of LM training on the port: the flash attention backward
kernels (``kernels.flash_attention.flash_attention_bwd``, dQ then dK/dV)
against their plain version, the forward's row log-sum-exp, the attention
under autograd through ``FlashAttentionFn``, and one training step at a
smoke config on the card against the same step on the CPU. They skip
without a card; run them on one with ``pytest -m cuda
tests/test_torch_cuda_lm_train.py`` (README). Imports no JAX.

Gates: every gradient against the plain backward evaluated in float64 on
the same inputs; bf16 within ``2e-2 * max|ref|`` (the forward's bf16
gate: P and dS are rounded to bf16 for the products), fp32 within
``FP32_GATE * max|ref|`` (the forward's fp32 gate; the kernel's fp32 sums
over D and over a tile's keys or queries run in another order than the
float64 einsums: 2.2e-6 measured at 1,024 tokens); two launches on the
same inputs bitwise equal (no atomics).
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (
    F32_HEAD_DIMS, HEAD_DIMS, flash_attention, flash_attention_bwd,
    flash_attention_bwd_torch)
from repro_torch.models import layers
from repro_torch.models import transformer as lm
from repro_torch.train import (AdamWConfig, TrainConfig, init_opt_state,
                               make_train_step)

pytestmark = pytest.mark.cuda

BF16_GATE = 2e-2
FP32_GATE = 1e-5
# (B, Sq, Skv, H, KV, causal): square, ragged, Sq < Skv, full attention;
# then the edges of the bf16 kernels' tiling (128-row blocks of 64-row
# tiles): S = 200 (a multiple of neither), Sq 130 < Skv 200 (a key tile
# across the diagonal at offset 70), G = 1 and G = 8
SHAPES = [(2, 128, 128, 8, 2, True), (1, 130, 130, 4, 4, True),
          (2, 70, 200, 8, 1, True), (1, 50, 90, 4, 2, False),
          (1, 200, 200, 8, 2, True), (1, 130, 200, 8, 2, True),
          (2, 200, 200, 4, 4, True), (1, 200, 200, 8, 1, True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, D, dtype, dev, seed=0):
    B, Sq, Skv, H, KV, causal = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device=dev) / D ** 0.5
    k = torch.randn((B, Skv, KV, D), generator=g, device=dev)
    v = torch.randn((B, Skv, KV, D), generator=g, device=dev)
    do = torch.randn((B, Sq, H, D), generator=g, device=dev)
    return [t.to(dtype) for t in (q, k, v, do)], causal


def _close(got, ref, gate, what):
    d = float((got.double() - ref.double()).abs().max())
    scale = float(ref.abs().max())
    assert torch.isfinite(got).all(), what
    assert d <= gate * scale, (what, d, scale, d / scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernel_vs_float64(dev, shape, D, dtype):
    _backward_vs_float64(dev, shape, D, dtype)


@pytest.mark.parametrize("D", sorted(set(F32_HEAD_DIMS) - set(HEAD_DIMS)))
@pytest.mark.parametrize("shape", SHAPES[:4])
def test_backward_kernel_vs_float64_fp32_small_head_dims(dev, shape, D):
    """fp32 at the mini LMs' head dims 16 and 32 (the examples' LM
    training): the CUDA-core kernels with the first D/4 lanes of a row
    group holding the gradients' columns."""
    _backward_vs_float64(dev, shape, D, torch.float32)


def _backward_vs_float64(dev, shape, D, dtype):
    (q, k, v, do), causal = _inputs(shape, D, dtype, dev)
    out, lse = flash_attention(q, k, v, causal=causal, scale=1.0,
                               return_lse=True)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal,
                                            scale=1.0))
    d64 = [t.double() for t in (q, k, v, out, do)]
    s = torch.einsum("bqhd,bkhd->bhqk", d64[0],
                     d64[1].repeat_interleave(q.shape[2] // k.shape[2], 2))
    if causal:
        Sq, Skv = q.shape[1], k.shape[1]
        keep = (torch.arange(Sq, device=dev)[:, None] + Skv - Sq
                >= torch.arange(Skv, device=dev)[None])
        s = s.masked_fill(~keep, float("-inf"))
    _close(lse, torch.logsumexp(s, -1), 1e-5, "lse")
    want = flash_attention_bwd_torch(*d64, causal=causal, scale=1.0)
    got = flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                              scale=1.0)
    gate = BF16_GATE if dtype == torch.bfloat16 else FP32_GATE
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a, b, gate, name)
    again = flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                scale=1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_backward_kernel_strided_q(dev, D, dtype):
    """q a view with a head stride of 2D (as a slice of a fused projection's
    output): the kernels read it through its strides (the bf16 kernels by
    TMA maps over them); gradients against float64, bitwise twice, and
    equal to the same launch on a contiguous copy of q."""
    (q, k, v, do), causal = _inputs((2, 200, 200, 8, 2, True), D, dtype, dev)
    wide = torch.zeros((2, 200, 8, 2 * D), dtype=dtype, device=dev)
    wide[..., :D] = q
    qs = wide[..., :D]
    assert not qs.is_contiguous() and qs.stride(2) == 2 * D
    out, lse = flash_attention(qs, k, v, causal=causal, scale=1.0,
                               return_lse=True)
    want = flash_attention_bwd_torch(*(t.double() for t in (qs, k, v, out,
                                                             do)),
                                     causal=causal, scale=1.0)
    got = flash_attention_bwd(qs, k, v, out, do, lse, causal=causal,
                              scale=1.0)
    gate = BF16_GATE if dtype == torch.bfloat16 else FP32_GATE
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, gate, name)
    again = flash_attention_bwd(qs, k, v, out, do, lse, causal=causal,
                                scale=1.0)
    dense = flash_attention_bwd(q.contiguous(), k, v, out, do, lse,
                                causal=causal, scale=1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, dense))


@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_check_kernel_equals_plain(dev, D):
    """The wgmma helpers alone (``spira_wgmma_check``): a product from
    shared memory with both operands K-major and one with A from registers
    and B MN-major, on tiles loaded by the backward's TMA maps, against
    the plain version (fp32 sums of exact bf16 products: within 1e-5 of
    max|ref|; y against the kernel's own x rounded to bf16)."""
    from repro_torch.kernels.flash_attention import (wgmma_check,
                                                     wgmma_check_torch)
    g = torch.Generator(device=dev).manual_seed(D)
    a, b, v = (torch.randn((64, D), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    x, y = wgmma_check(a, b, v)
    xr, _ = wgmma_check_torch(a, b, v)
    _close(x, xr, 1e-5, "x")
    _close(y, x.to(torch.bfloat16).float() @ v.float(), 1e-5, "y")


def test_backward_rejects_what_it_does_not_take(dev):
    (q, k, v, do), _ = _inputs((1, 80, 64, 4, 2, True), 64, torch.float32,
                               dev)
    out, lse = flash_attention(q, k, v, causal=False, scale=1.0,
                               return_lse=True)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash_attention_bwd(q, k, v, out, do, lse, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(*(t.cpu() for t in (q, k, v, out, do, lse)),
                            causal=False, scale=1.0)
    # fp32 is compiled at head dims 16, 32, 64, 128 and 256; bf16 at 64-256
    for D, dt in ((48, torch.float32), (32, torch.bfloat16)):
        q2, k2, v2 = (t[..., :D].to(dt).contiguous() for t in (q, k, v))
        with pytest.raises(ValueError, match="head dim"):
            flash_attention_bwd(q2, k2, v2, q2, q2, lse, causal=False,
                                scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_attention_under_autograd(dev, dtype):
    """Grad-requiring inputs go through FlashAttentionFn: one forward and
    one backward launch, gradients against autograd through the plain
    path on the same inputs; without grad the same launch as before."""
    (q, k, v, do), _ = _inputs((2, 96, 96, 8, 2, True), 128, dtype, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launch_counts()
    o = layers.grouped_attention(*leaves, causal=True)
    got = torch.autograd.grad(o, leaves, do)
    n = launch_counts()
    assert n["flash_attention"] == 1 and n["flash_attention_bwd"] == 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    op = layers.grouped_attention(*plain, causal=True, backend="torch")
    want = torch.autograd.grad(op, plain, do)
    gate = BF16_GATE if dtype == torch.bfloat16 else 1e-4
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, gate, name)
    with torch.no_grad():
        o2 = layers.grouped_attention(*leaves, causal=True)
    assert torch.equal(o2, o.detach())


def _smoke(arch="yi-9b"):
    return dataclasses.replace(configs.get_config(arch, smoke=True),
                               head_dim=64)


def test_smoke_step_on_card_matches_cpu(dev):
    """One training step's gradients (the step's per-layer leaves,
    ``train.loop.step_leaves``; fp32 smoke config, heads 64 wide) on the
    card against the CPU, every leaf within 1e-4 of max(its largest
    magnitude, 1e-3 of the largest gradient: a leaf below that is rounding
    noise); then one ``make_train_step`` step on each: loss within 1e-5
    and grad norm within 1e-4 relative (the parameters are not compared:
    AdamW's first update is ±lr wherever |g| >> eps, so an element whose
    gradient is rounding noise may flip); one forward and one backward
    launch per layer (no remat), two forward launches with remat."""
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.train.loop import step_leaves
    cfg = _smoke()
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=64,
                                global_batch=2, seed=1), 0)
    grads, metrics = {}, {}
    for where in ("cpu", "cuda"):
        p = lm.init_params(cfg, 0, device="cpu")[0]
        p = {k: (v.to(where) if torch.is_tensor(v) else
                 {kk: {n: t.to(where) for n, t in vv.items()}
                  for kk, vv in v.items()}) for k, v in p.items()}
        tree, entries = step_leaves(p)
        flat = [x for _, leaf in entries
                for x in (leaf if isinstance(leaf, tuple) else (leaf,))]
        reset_launch_counts()
        with torch.enable_grad():
            loss = lm.loss_fn(tree, cfg, batch)
            grads[where] = [g.cpu() for g in torch.autograd.grad(loss, flat)]
        if where == "cuda":
            assert launch_counts()["flash_attention"] == cfg.n_layers
            assert launch_counts()["flash_attention_bwd"] == cfg.n_layers
        o = init_opt_state(p, AdamWConfig())
        metrics[where] = make_train_step(cfg, TrainConfig(remat=False))(
            p, o, batch)[2]
    top = max(float(g.abs().max()) for g in grads["cpu"])
    for a, b in zip(grads["cuda"], grads["cpu"]):
        d = float((a - b).abs().max())
        assert d <= 1e-4 * max(float(b.abs().max()), 1e-3 * top), d
    mc, mg = metrics["cpu"], metrics["cuda"]
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-5 * float(
        mc["loss"])
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= 1e-4 * \
        float(mc["grad_norm"])
    reset_launch_counts()
    p = lm.init_params(cfg, 0, device=dev)[0]
    make_train_step(cfg, TrainConfig(remat=True))(
        p, init_opt_state(p, AdamWConfig()), batch)
    assert launch_counts()["flash_attention"] == 2 * cfg.n_layers
    assert launch_counts()["flash_attention_bwd"] == cfg.n_layers

"""The reference's graph of a residual sparse UNet against a dense oracle,
and the configurations' reference against a frozen copy of the reference
as it stood before its layers took inputs, norms, residual adds,
transposed maps and bias-free convolutions.

The oracle computes every level on a dense grid with ``F.conv3d`` and
``F.conv_transpose3d``, masked to the level's voxels, and shares no code
with the reference: it checks the maps, the norms, the joins and the
written-out backward at once."""
from typing import Dict

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench.lib import check, inputs, reference, work
from perfbench.lib.reference import Layer
from perfbench.tests.test_perfbench_reference import small_cell

F64 = torch.float64
BASE, GRID, S = 16, 24, 2     # coords in [BASE, BASE + GRID), two scenes
CIN, CLASSES = 3, 4
NO_BIAS = dict(bias=False)

# every field: K = 1, 2, 3 and 5; a K = 2 downsample and its transposed
# upsample; the repo's K = 3 stride-2 and inverse layers; src, concat, a
# residual join with a 1x1 projection and one with the identity; the three
# norms; layers with and without a bias
TINY = [
    Layer("stem", CIN, 8, 3, 0, 0, save="l0"),
    Layer("s0", 8, 8, 5, 0, 0, norm="bn_relu", **NO_BIAS),
    Layer("down1", 8, 12, 2, 0, 1, norm="bn_relu", save="in1", **NO_BIAS),
    Layer("proj1", 12, 16, 1, 1, 1, norm="bn", save="sc1", **NO_BIAS),
    Layer("b1a", 12, 16, 3, 1, 1, src="in1", norm="bn_relu", **NO_BIAS),
    Layer("b1b", 16, 16, 3, 1, 1, norm="bn", add="sc1", save="r1",
          **NO_BIAS),
    Layer("b2a", 16, 16, 3, 1, 1, norm="bn_relu", **NO_BIAS),
    Layer("b2b", 16, 16, 3, 1, 1, norm="bn", add="r1", save="l1",
          **NO_BIAS),
    Layer("down2", 16, 16, 3, 1, 2),
    Layer("c2", 16, 16, 3, 2, 2),
    Layer("up2", 16, 16, 3, 2, 1),
    Layer("dec1", 32, 16, 3, 1, 1, concat="l1"),
    Layer("up1", 16, 8, 2, 1, 0, norm="bn_relu", transposed=True,
          **NO_BIAS),
    Layer("dec0", 16, 8, 3, 0, 0, concat="l0", norm="bn", **NO_BIAS),
    Layer("tail", 8, 8, 1, 0, 0),
]
OPT = reference.AdamW(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                      grad_clip=1.0, warmup_steps=5, total_steps=100)


def scenes(seed: int = 3):
    """Two scenes: a slab of ground and scattered voxels, guard-biased."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(S):
        g = np.argwhere((rng.random((GRID,) * 3) < 0.06)
                        | (np.arange(GRID)[None, None, :] < 2)
                        & (rng.random((GRID,) * 3) < 0.5))
        out.append((g + BASE).astype(np.int32))
    feats = [rng.standard_normal((len(c), CIN)).astype(np.float32)
             for c in out]
    labels = [rng.integers(-1, CLASSES, len(c)).astype(np.int32)
              for c in out]
    return out, feats, labels


def tiny_weights(seed: int = 4) -> Dict[str, torch.Tensor]:
    w = inputs.weights(TINY, {"n_classes": CLASSES}, seed, "cpu", F64)
    # biases large enough that a dropped or doubled one shows
    return {k: v * 25 if k.endswith(".bias") else v for k, v in w.items()}


# ---------------------------------------------------------------------------
# the dense oracle
# ---------------------------------------------------------------------------

def masks(coords) -> Dict[int, torch.Tensor]:
    """Per level the active cells [S, n, n, n] of grid index
    ``(c - BASE) >> m``."""
    out = {}
    for m in range(3):
        n = GRID >> m
        a = torch.zeros((S, n, n, n), dtype=torch.bool)
        for b, c in enumerate(coords):
            i = torch.from_numpy(c.astype(np.int64) - BASE) >> m
            a[b, i[:, 0], i[:, 1], i[:, 2]] = True
        out[m] = a
    return out


def scatter(rows, coords, C):
    """Per-scene rows onto the level-0 grid [S, C, n, n, n]."""
    d = torch.zeros((S, C, GRID, GRID, GRID), dtype=rows[0].dtype)
    for b, (r, c) in enumerate(zip(rows, coords)):
        i = torch.from_numpy(c.astype(np.int64) - BASE)
        d[b, :, i[:, 0], i[:, 1], i[:, 2]] = r.t()
    return d


def dense_conv(x, w, L: Layer):
    K = L.K
    wk = w.reshape(K, K, K, L.cin, L.cout)
    W = wk.permute(4, 3, 0, 1, 2)
    if L.m_in == L.m_out:
        return F.conv3d(x, W, padding=(K - 1) // 2)
    if L.m_out == L.m_in + 1 and K == 2:
        return F.conv3d(x, W, stride=2)
    if L.m_out == L.m_in + 1 and K == 3:
        return F.conv3d(x, W, stride=2, padding=1)
    if L.m_out == L.m_in - 1 and L.transposed and K == 2:
        return F.conv_transpose3d(x, wk.permute(3, 4, 0, 1, 2), stride=2)
    if L.m_out == L.m_in - 1 and K == 3:
        # the untransposed inverse: a fine cell reads the coarse cells at
        # +-1 fine steps, so the coarse values sit at even fine cells
        n = x.shape[-1]
        fine = x.new_zeros(x.shape[:2] + (2 * n,) * 3)
        fine[..., ::2, ::2, ::2] = x
        return F.conv3d(fine, W, padding=1)
    raise ValueError(f"no dense form for {L}")


def dense_std(y, mask):
    m = mask[:, None].to(y.dtype)
    cnt = m.sum((2, 3, 4), keepdim=True).clamp(min=1.0)
    mean = (y * m).sum((2, 3, 4), keepdim=True) / cnt
    var = ((y * y * m).sum((2, 3, 4), keepdim=True) / cnt
           - mean * mean).clamp(min=0.0)
    return (y - mean) / torch.sqrt(var + 1e-5) * m


def dense_forward(coords, feats, layers, w, act):
    """Logits of the last level's cells, in (scene, x, y, z) order."""
    saved, x = {}, scatter(feats, coords, feats[0].shape[1])
    for L in layers:
        if L.src is not None:
            x = saved[L.src]
        if L.concat is not None:
            x = torch.cat([x, saved[L.concat]], 1)
        m = act[L.m_out][:, None].to(x.dtype)
        y = dense_conv(x, w[f"layers.{L.name}.weight"], L)
        if L.bias:
            y = y + w[f"layers.{L.name}.bias"][None, :, None, None, None]
        y = y * m
        if L.norm == "relu_bn":
            x = dense_std(torch.relu(y), act[L.m_out])
        elif L.norm == "bn_relu":
            x = torch.relu(dense_std(y, act[L.m_out]))
        else:
            x = dense_std(y, act[L.m_out])
        if L.add is not None:
            x = torch.relu(x + saved[L.add]) * m
        if L.save is not None:
            saved[L.save] = x
    idx = act[layers[-1].m_out].nonzero()
    rows = x[idx[:, 0], :, idx[:, 1], idx[:, 2], idx[:, 3]]
    return rows @ w["head"]


def dense_labels(coords, labels, act):
    d = scatter([torch.from_numpy(lab[:, None].astype(np.int64))
                 for lab in labels], coords, 1)[:, 0]
    idx = act[0].nonzero()
    return d[idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]]


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_levels_are_the_dense_masks():
    coords, _, _ = scenes()
    plan = reference.build_plan(coords, TINY, "cpu")
    for m, a in masks(coords).items():
        idx = a.nonzero()
        want = torch.cat([idx[:, :1], (idx[:, 1:] << m) + BASE], 1)
        assert torch.equal(plan.levels[m].bxyz, want), m


def test_forward_matches_the_dense_oracle():
    coords, feats, _ = scenes()
    w = tiny_weights()
    plan = reference.build_plan(coords, TINY, "cpu")
    with torch.no_grad():
        got = reference.forward(
            plan, TINY, reference.input_rows(plan, feats, "cpu", F64), w)
        want = dense_forward(coords, [torch.from_numpy(f).double()
                                      for f in feats], TINY, w,
                             masks(coords))
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-12, rel(got, want)


def test_a_k2_downsample_partitions_its_input_and_its_transpose_is_exact():
    coords, _, _ = scenes()
    plan = reference.build_plan(coords, TINY, "cpu")
    by = {L.name: L for L in TINY}
    down = reference.layer_cols(plan, by["down1"])
    up = reference.layer_cols(plan, by["up1"])
    src = torch.cat([s for _, s in down])
    assert torch.equal(torch.sort(src).values,
                       torch.arange(plan.levels[0].keys.numel()))
    assert len(down) == len(up) == 8
    for (r_d, s_d), (r_u, s_u) in zip(down, up):
        assert sorted(zip(r_u.tolist(), s_u.tolist())) == \
            sorted(zip(s_d.tolist(), r_d.tolist()))


def test_first_training_step_matches_autograd_through_the_oracle():
    coords, feats, labels = scenes()
    w = tiny_weights()
    plan = reference.build_plan(coords, TINY, "cpu")
    ref = reference.train_steps(
        [plan], [reference.input_rows(plan, feats, "cpu", F64)],
        [reference.input_rows(plan, labels, "cpu", None).long()],
        TINY, w, OPT)
    act = masks(coords)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    logits = dense_forward(coords, [torch.from_numpy(f).double()
                                    for f in feats], TINY, leaves, act)
    lab = dense_labels(coords, labels, act)
    valid = lab >= 0
    loss = F.cross_entropy(logits[valid], lab[valid])
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = min(OPT.grad_clip / float(norm), 1.0)
    assert abs(ref["losses"][0] - loss.item()) <= 1e-10 * loss.item()
    assert set(ref["first_grad"]) == set(grads)
    assert all(f"layers.{L.name}.bias" not in grads for L in TINY
               if not L.bias)
    for k, g in grads.items():
        assert rel(ref["first_grad"][k], g * scale) <= 1e-10, k


# ---------------------------------------------------------------------------
# the configurations' cells read what they read before
# ---------------------------------------------------------------------------

def frozen_pairs(plan, layers):
    """Each layer's map as the reference searched it before: the input at
    ``out + delta_k``, one map per (m_in, m_out, K)."""
    pairs = {}
    for L in layers:
        key = (L.m_in, L.m_out, L.K)
        if key in pairs:
            continue
        src, dst = plan.levels[L.m_in], plan.levels[L.m_out]
        cols = []
        for d in reference.offsets(L.K, L.stride):
            q = dst.bxyz.clone()
            q[:, 1:] += torch.as_tensor(d, device=q.device)
            qk = reference.keys(q)
            pos = torch.searchsorted(src.keys, qk).clamp(
                max=src.keys.numel() - 1)
            hit = src.keys[pos] == qk
            rows = torch.nonzero(hit).flatten()
            cols.append((rows, pos[rows]))
        pairs[key] = cols
    return pairs


def frozen_mm(a, b, tf32):
    if tf32 and a.dtype == torch.float32:
        def r(x):
            bits = x.contiguous().view(torch.int32)
            return ((bits + 0x1000) & -0x2000).view(torch.float32)
        return r(a) @ r(b)
    return a @ b


def frozen_forward(plan, pairs, layers, feats, weights, tf32=False):
    """The reference's forward before its layers took more fields."""
    saved, x = {}, feats
    for L in layers:
        if L.concat is not None:
            x = torch.cat([x, saved[L.concat]], dim=1)
        lv = plan.levels[L.m_out]
        w = weights[f"layers.{L.name}.weight"]
        y = x.new_zeros((lv.keys.numel(), w.shape[-1]))
        for k, (rows, src) in enumerate(pairs[(L.m_in, L.m_out, L.K)]):
            if rows.numel():
                y.index_add_(0, rows, frozen_mm(x[src], w[k], tf32))
        y = torch.relu(y + weights[f"layers.{L.name}.bias"])
        C = y.shape[1]
        denom = lv.counts.to(y.dtype).clamp(min=1.0)[:, None]
        s1 = y.new_zeros((plan.n_scenes, C)).index_add(0, lv.sid, y)
        s2 = y.new_zeros((plan.n_scenes, C)).index_add(0, lv.sid, y * y)
        mean = s1 / denom
        var = (s2 / denom - mean * mean).clamp(min=0.0)
        inv = torch.rsqrt(var + reference.EPS_BN)
        x = (y - mean[lv.sid]) * inv[lv.sid]
        if L.save is not None:
            saved[L.save] = x
    return frozen_mm(x, weights["head"], tf32)


def frozen_weights(layers, cfg, seed, device, dtype=torch.float32):
    shapes = []
    for L in layers:
        k3 = L.K ** 3
        shapes.append((f"layers.{L.name}.weight", (k3, L.cin, L.cout),
                       (k3 * L.cin) ** -0.5))
        shapes.append((f"layers.{L.name}.bias", (L.cout,), 0.02))
    shapes.append(("head", (layers[-1].cout, cfg["n_classes"]), 0.02))
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for (name, shape, scale), n in zip(shapes, sizes):
        out[name] = (flat[at:at + n] * scale).reshape(shape)
        at += n
    return out


@pytest.mark.parametrize("name", ["unet42-outdoor-b2", "resnl20-outdoor-b2"])
def test_the_configurations_read_what_they_read_before(name, monkeypatch):
    c = small_cell(name, monkeypatch)
    (batch,) = inputs.pool(7, c.mix, c.cfg)
    seed = 2 ** 31 + 7
    w = inputs.weights(c.layers, c.cfg, seed, "cpu")
    old_w = frozen_weights(c.layers, c.cfg, seed, "cpu")
    assert list(w) == list(old_w)
    assert all(torch.equal(w[k], old_w[k]) for k in w)
    plan = reference.build_plan(batch.coords, c.layers, "cpu")
    old = frozen_pairs(plan, c.layers)
    for L in c.layers:
        for (r, s), (r0, s0) in zip(reference.layer_cols(plan, L),
                                    old[(L.m_in, L.m_out, L.K)]):
            assert torch.equal(r, r0) and torch.equal(s, s0), L.name
    pairs, rows = check._shape(plan, c.layers)
    old_pairs = [np.array([int(r.numel()) for r, _ in
                           old[(L.m_in, L.m_out, L.K)]], np.int64)
                 for L in c.layers]
    for train in (False, True):
        assert work.call_work(c.layers, pairs, rows, c.cfg["n_classes"],
                              train=train) == \
            work.call_work(c.layers, old_pairs, rows, c.cfg["n_classes"],
                           train=train)
    for dtype, tf32 in ((F64, False), (torch.float32, True)):
        f = reference.input_rows(plan, batch.feats, "cpu", dtype)
        wd = {k: v.to(dtype) for k, v in w.items()}
        reference.TF32["on"] = tf32
        try:
            with torch.no_grad():
                got = reference.forward(plan, c.layers, f, wd)
        finally:
            reference.TF32["on"] = False
        assert torch.equal(got, frozen_forward(plan, old, c.layers, f, wd,
                                               tf32)), dtype

"""The port's logical-axis sharding (``repro_torch.dist.sharding``) against
the reference's (``repro.dist.sharding``), and the logical axes the port's
models record against the reference's.

Both resolutions are pure functions of (logical axes, shape, mesh axis
names and sizes, policy), so they are compared on abstract meshes —
``jax.sharding.AbstractMesh`` for the reference, the port's
``AbstractMesh`` — of the four shapes the reference runs: (1, 1), (2, 4),
(16, 16) and (2, 16, 16), with ``fsdp`` and ``seq_shard`` both ways, over
every leaf of every configured architecture at full size and over the
activation constraints the models apply. Exact equality throughout.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro import configs as jconfigs
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.dist import sharding as tsh
from repro_torch.models import transformer as ttf

ARCHS = sorted(tconfigs.ARCHS)
MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]

# activation constraints the models apply (logical axes, a shape each)
ACTS = [(("batch", "seq", "d_model"), (256, 4096, 4096)),
        (("batch", "seq_sp", "d_model"), (256, 4096, 4096)),
        (("batch", "seq", "vocab"), (256, 4096, 64000)),
        (("batch", "seq", "heads", None), (256, 4096, 32, 128)),
        (("batch", "seq", None, "d_ff"), (256, 4096, 2, 11008)),
        (("batch", "kv_seq", "kv_heads", None), (128, 32768, 4, 128)),
        (("batch", None, None, "kv_seq"), (128, 32, 1, 32768)),
        (("batch", "heads", None, None), (128, 32, 1, 32768)),
        (("experts", "expert_cap", None), (128, 81920, 2048)),
        (("experts", "expert_cap", None, "expert_ff"),
         (128, 81920, 2, 768)),
        (("batch", "seq", "d_ff"), (1, 4096, 16384)),
        (("batch",), (3,)), (("batch", "seq"), (1, 7))]


def _ref_tree(arch):
    shapes, axes = jtf.abstract_params(jconfigs.get_config(arch))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {"/".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in flat}, axes


def _port_tree(arch):
    params, axes = ttf.abstract_params(tconfigs.get_config(arch))
    out = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                out[f"{pre}{k}"] = v
    walk(params, "")
    return out, axes


@pytest.fixture(scope="module")
def trees():
    return {a: (_ref_tree(a), _port_tree(a)) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_axes_shapes_and_count_equal_the_reference(
        trees, arch):
    (ref_shapes, ref_axes), (leaves, axes) = trees[arch]
    assert axes == ref_axes
    assert {k: tuple(v.shape) for k, v in leaves.items()} == ref_shapes
    assert all(v.device.type == "meta" for v in leaves.values())
    assert sum(v.numel() for v in leaves.values()) == sum(
        int(np.prod(s)) for s in ref_shapes.values())
    dt = tconfigs.get_config(arch).param_dtype
    assert {v.dtype for v in leaves.values()} == {dt}


@pytest.mark.parametrize("arch", ["yi-9b", "jamba-1.5-large-398b"])
def test_init_params_records_the_abstract_axes(arch):
    """``init_params`` and ``abstract_params`` record the same table (one
    drawing ctx, one shape ctx); drawn at the smoke size."""
    cfg = tconfigs.get_config(arch, smoke=True)
    params, axes = ttf.init_params(cfg, 0, device="cpu")
    _, abstract_axes = ttf.abstract_params(cfg)
    assert axes == abstract_axes
    shapes = _flat(ttf.param_shapes(cfg))
    assert {k: tuple(v.shape) for k, v in _flat(params).items()} == shapes
    assert {k: tuple(v.shape) for k, v in
            _flat(ttf.abstract_params(cfg)[0]).items()} == shapes


@pytest.mark.parametrize("shape,names", MESHES)
@pytest.mark.parametrize("fsdp,seq_shard",
                         list(itertools.product((True, False), repeat=2)))
def test_spec_for_equals_the_reference(trees, shape, names, fsdp,
                                       seq_shard):
    jm = JaxAbstractMesh(shape, names)
    tm = tsh.AbstractMesh(shape, names)
    cases = list(ACTS)
    for arch in ARCHS:
        (ref_shapes, ref_axes), _ = trees[arch]
        cases += [(ref_axes[k], s) for k, s in ref_shapes.items()]
    with jsh.sharding_ctx(jm, fsdp=fsdp, seq_shard=seq_shard):
        want = [tuple(jsh.spec_for(lg, s)) for lg, s in cases]
        want_free = [tuple(jsh.spec_for(lg)) for lg, _ in ACTS]
    with tsh.sharding_ctx(tm, fsdp=fsdp, seq_shard=seq_shard):
        got = [tsh.spec_for(lg, s) for lg, s in cases]
        got_free = [tsh.spec_for(lg) for lg, _ in ACTS]
        assert tsh.seq_shard_active() == seq_shard
    assert got == want
    assert got_free == want_free
    sizes = dict(zip(names, shape))
    assert [tsh.resolve_spec(lg, s, sizes, fsdp=fsdp, seq_shard=seq_shard)
            for lg, s in cases] == want


@pytest.mark.parametrize("shape,names", MESHES)
def test_param_shardings_and_batch_spec_equal_the_reference(trees, shape,
                                                            names):
    jm = JaxAbstractMesh(shape, names)
    tm = tsh.AbstractMesh(shape, names)
    (ref_shapes, ref_axes), (leaves, axes) = trees["qwen3-moe-30b-a3b"]
    with jsh.sharding_ctx(jm):
        want = {k: tuple(jsh.spec_for(ref_axes[k], s))
                for k, s in ref_shapes.items()}
    with tsh.sharding_ctx(tm):
        got = tsh.param_shardings(axes, _nest(leaves))
    assert {k: v.spec for k, v in _flat(got).items()} == want
    for b in (1, 2, 3, 8, 32, 128, 256, 512):
        assert tsh.batch_spec(tm, b) == tuple(jspecs._batch_spec(jm, b))


def _nest(flat):
    out = {}
    for k, v in flat.items():
        d = out
        *head, last = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = v
    return out


def test_param_shardings_fails_loudly():
    """A leaf without recorded axes, or with axes of another rank,
    raises (the reference asserts both)."""
    tm = tsh.AbstractMesh((2, 2), ("data", "model"))
    with tsh.sharding_ctx(tm):
        with pytest.raises(KeyError, match="no logical axes"):
            tsh.param_shardings({}, {"w": torch.empty(2, 2)})
        with pytest.raises(ValueError, match="axes"):
            tsh.param_shardings({"w": ("d_model",)},
                                {"w": torch.empty(2, 2)})
    with pytest.raises(RuntimeError, match="sharding_ctx"):
        tsh.param_shardings({"w": (None, None)}, {"w": torch.empty(2, 2)})


def test_placements_for_the_reference_specs():
    from torch.distributed.tensor import Replicate, Shard
    m2 = tsh.AbstractMesh((16, 16), ("data", "model"))
    m3 = tsh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tsh.placements_for(("data", "model"), m2) == (Shard(0), Shard(1))
    assert tsh.placements_for((None, "data", "model"), m3) == (
        Replicate(), Shard(1), Shard(2))
    assert tsh.placements_for((("pod", "data"),), m3) == (
        Shard(0), Shard(0), Replicate())
    assert tsh.placements_for((), m2) == (Replicate(), Replicate())
    assert tsh.placements_for((None, None, "model"), m2) == (
        Replicate(), Shard(2))


def test_shard_act_is_the_identity_outside_the_context():
    x = torch.randn(2, 3, 4)
    assert tsh.shard_act(x, ("batch", "seq", "d_model")) is x
    assert tsh.spec_for(("batch", "seq", "d_model"), x.shape) == ()
    assert not tsh.seq_shard_active()
    with tsh.sharding_ctx(tsh.AbstractMesh((2, 2), ("data", "model"))):
        # a plain tensor passes through inside the context as well
        assert tsh.shard_act(x, ("batch", "seq", "d_model")) is x


def test_helpers_on_plain_tensors_are_the_plain_ops():
    """``local_linear``, ``local_batch`` and the loss's pieces (log-sum-exp,
    embedding lookup, gold logit, sum) on plain tensors compute bitwise what
    the plain ops compute, gradients included (the DTensor forms must equal
    them at world size 1)."""
    from repro_torch.models import common
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 8), generator=g)
    w = torch.randn((8, 2, 6), generator=g)
    assert torch.equal(common.proj(x, w),
                       (x @ w.reshape(8, 12)).unflatten(-1, (2, 6)))
    assert torch.equal(common.matmul(x, w[:, 0]), x @ w[:, 0])
    assert torch.equal(tsh.local_batch(torch.neg, (x,)), -x)
    logits = torch.randn((2, 7, 50), generator=g, requires_grad=True)
    logits2 = logits.detach().clone().requires_grad_()
    mine = ttf._LogSumExp.apply(logits)
    ref = torch.logsumexp(logits2, dim=-1)
    assert torch.equal(mine, ref)
    dy = torch.randn(ref.shape, generator=g)
    (a,), (b,) = (torch.autograd.grad(mine, logits, dy),
                  torch.autograd.grad(ref, logits2, dy))
    assert torch.equal(a, b)
    inf = torch.full((1, 3), float("-inf"))
    assert torch.equal(ttf._LogSumExp.apply(inf), torch.logsumexp(inf, -1))
    labels = torch.randint(0, 50, (2, 7), generator=g)
    mine, ref = ttf._gold(logits, labels), logits2.gather(
        -1, labels[..., None])[..., 0]
    assert torch.equal(mine, ref)
    (a,), (b,) = (torch.autograd.grad(mine, logits, dy),
                  torch.autograd.grad(ref, logits2, dy))
    assert torch.equal(a, b)
    assert torch.equal(ttf._total(mine), torch.sum(ref))
    table = torch.randn((50, 8), generator=g, requires_grad=True)
    table2 = table.detach().clone().requires_grad_()
    mine = ttf._lookup(table, labels, torch.bfloat16)
    ref = table2.to(torch.bfloat16)[labels]
    assert torch.equal(mine, ref)
    dy = torch.randn(ref.shape, generator=g).to(torch.bfloat16)
    (a,), (b,) = (torch.autograd.grad(mine, table, dy),
                  torch.autograd.grad(ref, table2, dy))
    assert torch.equal(a, b)

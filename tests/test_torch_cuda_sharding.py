"""Card-only tests of the multi-card layer at world size 1: the training
step on DTensors over a one-rank NCCL ``(1, 1)`` mesh against the plain
step, and reshard-on-load both ways. They skip without a card; run them
on one with ``pytest -m cuda tests/test_torch_cuda_sharding.py``
(README). Imports no JAX.

Gates: bitwise. At world size 1 every redistribution moves nothing and
each rank's local operations are the plain step's own, so the losses and
every parameter and moment are equal in every bit; the flash kernels run
through ``local_map`` on the rank's heads and are counted.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.data.tokens import DataConfig, batch_at
from repro_torch.dist.sharding import (distribute_params, is_dtensor,
                                       param_shardings, sharding_ctx)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import transformer as lm
from repro_torch.models.common import SuperBlock
from repro_torch.train import (AdamWConfig, TrainConfig, init_opt_state,
                               make_train_step)
from repro_torch.train.loop import checkpoint_trees, restore

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_single, make_host_mesh
    owned = not dist.is_initialized()
    init_single("cuda")
    yield make_host_mesh(device_type="cuda")
    if owned:
        dist.destroy_process_group()


def _cut(layers=2):
    full = configs.get_config("yi-9b")
    return dataclasses.replace(
        full, name=f"yi-9b ({layers} layers)",
        superblocks=(SuperBlock(blocks=(("attn", "dense"),), repeat=layers),))


def _named(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = v.to_local() if is_dtensor(v) else v
    return out


def _state(p, o):
    return {**{f"p/{k}": v for k, v in _named(p).items()},
            **{f"m/{k}": v for k, v in _named(o.mu).items()},
            **{f"v/{k}": v for k, v in _named(o.nu).items()}}


def test_sharded_step_is_bitwise_the_plain_step(mesh):
    """yi-9b at full width, 2 layers, seq 256 x batch 2, remat: two steps
    on the (1, 1) mesh (FSDP and TP rules on) equal the plain steps in
    every bit, with 2 x 2 flash forward (remat recomputes them) and 2
    backward launches per step."""
    cfg = _cut()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=2, seed=5)
    step = make_train_step(cfg, TrainConfig(remat=True))
    p, axes = lm.init_params(cfg, 0, device="cuda")
    o = init_opt_state(p, AdamWConfig())
    losses = []
    for i in range(2):
        p, o, m = step(p, o, batch_at(dcfg, i))
        losses.append(float(m["loss"]))
    with sharding_ctx(mesh, fsdp=True):
        q = distribute_params(lm.init_params(cfg, 0, device="cuda")[0],
                              axes)
        qo = init_opt_state(q, AdamWConfig())
        reset_launch_counts()
        got = []
        for i in range(2):
            q, qo, m = step(q, qo, batch_at(dcfg, i))
            got.append(float(m["loss"]))
        counts = launch_counts()
    assert got == losses
    assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (8, 4)
    a, b = _state(p, o), _state(q, qo)
    assert a.keys() == b.keys()
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


@pytest.mark.parametrize("source", ["sharded", "plain"])
def test_reshard_on_load_both_ways(mesh, tmp_path, source):
    """A checkpoint of the sharded state restores into plain tensors, and
    one of the plain state into DTensors on the mesh (``shardings=``); one
    step after either is bitwise the uninterrupted run's (yi-9b's smoke
    config with heads of 64, the kernels' smallest)."""
    cfg = dataclasses.replace(configs.get_config("yi-9b", smoke=True),
                              head_dim=64)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=6)
    step = make_train_step(cfg, TrainConfig(remat=True))
    with sharding_ctx(mesh, fsdp=True):
        p, axes = lm.init_params(cfg, 0, device="cuda")
        if source == "sharded":
            p = distribute_params(p, axes)
        o = init_opt_state(p, AdamWConfig())
        p, o, _ = step(p, o, batch_at(dcfg, 0))
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(0, *checkpoint_trees(p, o))
        p, o, _ = step(p, o, batch_at(dcfg, 1))
        q, _ = lm.init_params(cfg, 1, device="cuda")
        qo = init_opt_state(q, AdamWConfig())
        if source == "sharded":
            q, qo, at = restore(mgr, q, qo)
            assert not any(is_dtensor(t) for t in _named(q).values())
        else:
            sh = param_shardings(axes, lm.abstract_params(cfg)[0])
            q, o2, at = mgr.restore(None, q, checkpoint_trees(q, qo)[1],
                                    shardings=sh,
                                    opt_shardings={".mu": sh, ".nu": sh})
            qo = type(qo)(o2[".mu"], o2[".nu"], int(o2[".step"]))
            assert is_dtensor(q["sb0"]["b0"]["wq"])
        q, qo, _ = step(q, qo, batch_at(dcfg, 1))
    assert at == 0
    a, b = _state(p, o), _state(q, qo)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []

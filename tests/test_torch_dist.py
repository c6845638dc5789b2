"""The port's sharded training on several CPU processes (gloo), mirroring
the reference's ``tests/test_dist.py``: the step on a (2, 2) mesh, an
elastic restart from (2, 2) to (4, 1), and the launcher with ``--mesh host
--fsdp``. The reference's own tests fail under this JAX (its launcher and
sharded step raise ``ShardingTypeError``), so the oracle is the port's
single-process step on the same parameters and batches.

Tolerance: the reference's, 1e-4 on the loss and on every parameter. The
sharded step adds in another order — row-parallel partial sums, the data
axis's gradient reduce-scatter, the norm's all-reduce — and AdamW's first
updates are ±lr for gradient elements near rounding noise (lr 3e-4 after
warm-up at step 0: 3e-6), so a parameter may differ by a few lr.

Each script runs in a subprocess (a process group is global state) with a
time limit; its ranks are spawned processes on one free localhost port.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-4

COMMON = r"""
import json, os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.dist.sharding import (distribute_params, param_shardings,
                                       sharding_ctx, to_local_tree)
from repro_torch.launch.mesh import free_port, make_mesh
from repro_torch.models.common import dense_lm, moe_lm
from repro_torch.models import transformer as tf
from repro_torch.train import (AdamWConfig, TrainConfig, init_opt_state,
                               make_train_step)
from repro_torch.data.tokens import DataConfig, batch_at


def flat(t, pre=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def maxdiff(a, b):
    a, b = flat(a), flat(b)
    assert a.keys() == b.keys()
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def start(rank, world, port):
    torch.set_num_threads(1)        # 4 ranks share the test's CPU cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)


def run(main, world=4):
    mp.spawn(main, args=(world, free_port()), nprocs=world)
"""

STEP = COMMON + r"""
def main(rank, world, port):
    start(rank, world, port)
    cfg = moe_lm("tiny", n_layers=2, d_model=64, n_heads=8, n_kv=4,
                 d_ff_expert=64, vocab=256, n_experts=8, top_k=2,
                 capacity_factor=2.0, dtype="float32")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0)
    tcfg = TrainConfig(remat=True)
    step = make_train_step(cfg, tcfg)
    p, axes = tf.init_params(cfg, 0, device="cpu")
    p_ref, _, m_ref = step(p, init_opt_state(p, tcfg.opt), batch_at(dcfg, 0))
    # AdamW's first update is ±lr whatever the gradient's size: the
    # gradient norm is what holds the gradients' scale
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    with sharding_ctx(mesh, fsdp=True):
        q, _ = tf.init_params(cfg, 0, device="cpu")
        sh = param_shardings(axes, q)
        q = distribute_params(q, axes)
        q, _, m = step(q, init_opt_state(q, tcfg.opt), batch_at(dcfg, 0))
        full = to_local_tree(q)
    specs = list(flat(sh).values())
    if rank == 0:
        print(json.dumps({
            "loss_err": abs(float(m_ref["loss"]) - float(m["loss"])),
            "gnorm_err": abs(float(m_ref["grad_norm"])
                             - float(m["grad_norm"])) / float(
                                 m_ref["grad_norm"]),
            "param_maxdiff": maxdiff(p_ref, full),
            "n_sharded": sum(1 for s in specs if s.spec != ()),
            "n_total": len(specs),
            "experts": str(flat(sh)["sb0/f0/wi"].placements)}))
    dist.destroy_process_group()


if __name__ == "__main__":
    run(main)
"""

ARCHS = COMMON + r"""
from repro_torch import configs


def main(rank, world, port):
    start(rank, world, port)
    out = {}
    for arch in ("jamba-1.5-large-398b", "xlstm-350m"):
        cfg = configs.get_config(arch, smoke=True)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4,
                          seed=1)
        step = make_train_step(cfg, TrainConfig(remat=True))
        p, axes = tf.init_params(cfg, 0, device="cpu")
        _, _, m_ref = step(p, init_opt_state(p, AdamWConfig()),
                           batch_at(dcfg, 0))
        with sharding_ctx(make_mesh((2, 2), ("data", "model"), "cpu"),
                          fsdp=True):
            q = distribute_params(tf.init_params(cfg, 0, device="cpu")[0],
                                  axes)
            _, _, m = step(q, init_opt_state(q, AdamWConfig()),
                           batch_at(dcfg, 0))
        out[arch] = [abs(float(m_ref[k]) - float(m[k])) / abs(float(m_ref[k]))
                     for k in ("loss", "grad_norm")]
    if rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()


if __name__ == "__main__":
    run(main)
"""

ELASTIC = COMMON + r"""
from repro_torch.ckpt import CheckpointManager
from repro_torch.train.loop import checkpoint_trees, restore

CKDIR = sys.argv[1]
cfg = dense_lm("tiny", n_layers=2, d_model=64, n_heads=8, n_kv=4, d_ff=128,
               vocab=256, dtype="float32")
dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3), remat=False)


def steps(p, o, start, n):
    step = make_train_step(cfg, tcfg)
    for s in range(start, start + n):
        p, o, m = step(p, o, batch_at(dcfg, s))
    return p, o, m


def main(rank, world, port):
    start(rank, world, port)
    p, axes = tf.init_params(cfg, 0, device="cpu")
    p_ref, _, m_ref = steps(p, init_opt_state(p, tcfg.opt), 0, 6)
    mgr = CheckpointManager(CKDIR, async_save=False)
    # 3 steps on (2, 2), checkpoint
    with sharding_ctx(make_mesh((2, 2), ("data", "model"), "cpu"),
                      fsdp=True):
        q, _ = tf.init_params(cfg, 0, device="cpu")
        q = distribute_params(q, axes)
        q, o, _ = steps(q, init_opt_state(q, tcfg.opt), 0, 3)
        mgr.save(2, *checkpoint_trees(q, o))
    dist.barrier()
    # restart on a different mesh, (4, 1): restore into its DTensors
    with sharding_ctx(make_mesh((4, 1), ("data", "model"), "cpu"),
                      fsdp=True):
        r, _ = tf.init_params(cfg, 7, device="cpu")
        r = distribute_params(r, axes)
        r, o, at = restore(mgr, r, init_opt_state(r, tcfg.opt))
        r, _, m = steps(r, o, at + 1, 3)
        full = to_local_tree(r)
    if rank == 0:
        print(json.dumps({"at": at, "loss_err": abs(float(m_ref["loss"])
                                                    - float(m["loss"])),
                          "param_maxdiff": maxdiff(p_ref, full)}))
    dist.destroy_process_group()


if __name__ == "__main__":
    run(main)
"""


def _run(tmp_path, script, *args, env=None):
    path = tmp_path / "script.py"
    path.write_text(script)
    env = dict(os.environ if env is None else env,
               PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(path), *args], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sharded_train_step_matches_single_device(tmp_path):
    """FSDP + TP + EP on a (2, 2) gloo mesh of 4 processes: one step of the
    reference's tiny MoE config equals the single-process step, and every
    leaf with a shardable dim is sharded."""
    res = _run(tmp_path, STEP)
    assert res["loss_err"] < TOL, res
    assert res["gnorm_err"] < TOL, res
    assert res["param_maxdiff"] < TOL, res
    assert res["n_sharded"] >= res["n_total"] // 2, res
    assert res["experts"] == "(Shard(dim=2), Shard(dim=1))", res


def test_sharded_recurrent_archs_match_single_device(tmp_path):
    """Jamba's Mamba blocks with MoE FFNs and xLSTM's mLSTM and sLSTM
    blocks (their smoke configs) on the (2, 2) mesh: each recurrence runs
    per rank on its batch shard; the loss and the gradient norm of one
    step equal the single-process step's within the tolerance."""
    res = _run(tmp_path, ARCHS)
    for arch, errs in res.items():
        assert max(errs) < TOL, (arch, errs)


def test_elastic_restart_across_mesh_shapes(tmp_path):
    """Checkpoint after 3 steps on (2, 2), resume on (4, 1) for 3 more:
    the same as 6 straight steps (reshard-on-load)."""
    res = _run(tmp_path, ELASTIC, str(tmp_path / "ck"))
    assert res["at"] == 2
    assert res["loss_err"] < TOL, res
    assert res["param_maxdiff"] < TOL, res


LAUNCH_ARGS = ["--arch", "yi-9b", "--smoke", "--seq-len", "32",
               "--global-batch", "4", "--steps", "2", "--device", "cpu"]


def _plain_run(steps=2):
    """The launcher's two steps without a mesh: (losses, params)."""
    from repro_torch import configs
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.models import transformer as tf
    from repro_torch.train import (AdamWConfig, TrainConfig, init_opt_state,
                                   make_train_step)
    cfg = configs.get_config("yi-9b", smoke=True)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4, total_steps=steps),
                       remat=False)
    p, _ = tf.init_params(cfg, 0, device="cpu")
    o = init_opt_state(p, tcfg.opt)
    step = make_train_step(cfg, tcfg)
    losses = []
    for s in range(steps):
        p, o, m = step(p, o, batch_at(dcfg, s))
        losses.append(float(m["loss"]))
    return losses, p


def _ckpt_params(path):
    import numpy as np
    with np.load(path) as z:
        return {k[len("params::"):]: z[k] for k in z.files
                if k.startswith("params::")}


def test_launcher_mesh_host_fsdp_equals_the_unsharded_run(tmp_path,
                                                          capsys):
    """``launch/train.py --smoke --mesh host --fsdp --device cpu``: one
    process, a (1, 1) mesh (plain tensors: every placement is whole); its
    losses and last checkpoint's parameters are bitwise the unsharded
    run's."""
    import numpy as np
    from repro_torch.launch import train as launch_train
    launch_train.main(LAUNCH_ARGS + ["--mesh", "host", "--fsdp",
                                     "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    losses, p = _plain_run()
    assert "mesh 1x1" in out
    assert f"step 0 loss {losses[0]:.4f}" in out, out    # logs every 10
    got = _ckpt_params(tmp_path / "ck" / "ckpt_00000001.npz")
    from repro_torch.ckpt.manager import _leaves, _snapshot
    want = {k: _snapshot(v) for k, v in _leaves(p).items()}
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)


def test_launcher_on_four_ranks(tmp_path):
    """The launcher as ``torchrun`` starts it, one process per rank with
    the torch.distributed environment: ``--mesh host --fsdp`` is a (4, 1)
    mesh; its last checkpoint (written by rank 0) within the tolerance of
    the unsharded run's parameters."""
    import numpy as np
    from repro_torch.launch.mesh import free_port
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE="4", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_ARGS,
         "--mesh", "host", "--fsdp", "--ckpt-dir", str(tmp_path / "ck")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:]
                                                   for o in outs]
    assert "mesh 4x1" in outs[0][0] and "done; checkpoints: [0, 1]" in \
        outs[0][0], outs[0][0]
    assert all(o[0].strip() == "" for o in outs[1:])   # rank 0 logs
    _, p = _plain_run()
    got = _ckpt_params(tmp_path / "ck" / "ckpt_00000001.npz")
    from repro_torch.ckpt.manager import _leaves, _snapshot
    for k, v in _leaves(p).items():
        want = _snapshot(v)
        assert np.abs(got[k].astype(np.float64)
                      - want.astype(np.float64)).max() < TOL, k

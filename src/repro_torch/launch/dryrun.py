"""Dry run: build every (arch × shape × mesh) cell on ``meta`` and count it.

The port of ``repro/launch/dryrun.py``. For each cell this builds the
parameters, the AdamW state and the decode caches on the ``meta`` device
as DTensors placed by the production rules (``dist.sharding``), under a
fake process group of as many ranks as the mesh has
(``mesh.init_fake``: the counterpart of the reference's
``--xla_force_host_platform_device_count=512``), runs the real train
step, prefill or decode step under ``op_analysis.OpCounter`` — nothing is
computed or allocated — and records the per-device counts and the H100
roofline terms (``roofline``). Meshes: ``16x16`` and ``2x16x16``, the
reference's, and ``1x1``, one H100.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k \
      [--mesh 1x1|16x16|2x16x16] [--multi-pod] [--layers N] [--out PATH]
  python -m repro_torch.launch.dryrun --all [--mesh ...]  # every cell
  python -m repro_torch.launch.dryrun --spc minkunet42 [--device cuda]
Results accumulate in ``--out`` (default ``build/dryrun_results.json``;
cells already present are skipped unless ``--force``). ``--layers`` cuts
the depth (a tag of the cell), ``--batch`` / ``--seq`` the shape.
``--spc`` counts the paper's own workload on the device given: one
synthetic scene per card (``data/scenes.py``), the network plan and the
feature pass; point-cloud plans have data-dependent sizes, so they run on
real data, not on ``meta``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from .. import configs
from ..configs.shapes import SHAPES, ShapeSpec, applicable
from ..dist.sharding import (DEFAULT_RULES, NamedSharding, distribute,
                             distribute_params, is_dtensor, mesh_axes,
                             sharding_ctx)
from ..models import transformer as tf
from ..models.common import SuperBlock
from ..train import AdamWConfig, TrainConfig, init_opt_state, make_train_step
from . import roofline as rf
from .mesh import init_fake, make_mesh, parse_mesh
from .op_analysis import OpCounter
from .specs import decode_input_specs, train_input_specs

RESULTS = os.path.join("build", "dryrun_results.json")


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in a nested dict."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if is_dtensor(tree) else tree
        return t.numel() * t.element_size()
    return 0


def _state_spec(name: str, shape, sizes: dict, seq_shard: bool) -> tuple:
    """A decode-cache leaf's spec by its name and rank (the reference's
    ``_state_shardings``): the batch over ``("pod", "data")`` when it
    divides; KV heads over the model axis, else the cached sequence."""
    batch = tuple(a for a in ("pod", "data") if a in sizes)
    bsz = math.prod(sizes[a] for a in batch)
    b = (batch if len(batch) > 1 else batch[0]) if (
        batch and shape[1] % bsz == 0 and bsz > 1) else None
    m = sizes.get("model", 1)

    def model_ok(d):
        return "model" in sizes and d % m == 0
    if name in ("k", "v"):                  # [L, B, S, KV, D]
        if seq_shard and model_ok(shape[2]):
            return (None, b, "model")
        if model_ok(shape[3]):
            return (None, b, None, "model")
        if model_ok(shape[2]):
            return (None, b, "model")
        return (None, b)
    if name == "conv":                      # [L, B, ck, di]
        return (None, b, None, "model" if model_ok(shape[3]) else None)
    if name in ("ssm", "C"):                # [L, B, di, ds] / [L, B, H, ..]
        return (None, b, "model" if model_ok(shape[2]) else None)
    if name in ("n", "m", "c", "h"):
        return (None, b) + (("model" if model_ok(shape[2]) else None,)
                            if len(shape) > 2 else ())
    return ()


def _group(n: int) -> None:
    """A fake group of ``n`` ranks (a new one when the size differs)."""
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    init_fake(n)


def cut_config(arch: str, layers: int = 0):
    """The arch's config, its depth cut to ``layers`` repeats of its first
    superblock when given."""
    cfg = configs.get_config(arch)
    if layers:
        sb = cfg.superblocks[0]
        cfg = dataclasses.replace(
            cfg, name=f"{cfg.name} ({layers} layers)",
            superblocks=(SuperBlock(blocks=sb.blocks, repeat=layers),))
    return cfg


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
               mesh: str = "", fsdp: bool = True, remat: bool = True,
               seq_sp: bool = True, extra_tags: str = "", layers: int = 0,
               shape: ShapeSpec | None = None, cfg=None) -> dict:
    """Count one cell; returns the result record (the reference's keys).
    ``shape`` overrides the named shape, ``cfg`` the arch's config."""
    shape = shape or SHAPES[shape_name]
    cfg = cfg or cut_config(arch, layers)
    mesh = mesh or ("2x16x16" if multi_pod else "16x16")
    dims, names = parse_mesh(mesh)
    n_dev = math.prod(dims)
    _group(n_dev)
    dm = make_mesh(dims, names, "cpu")
    sizes = mesh_axes(dm)
    # shard the KV cache along sequence (split-K decode) when the context
    # is huge or the KV heads do not divide the model axis
    cache_seq_shard = shape.kind in ("decode", "prefill") and (
        shape.seq_len >= 100_000 or cfg.n_kv % sizes["model"] != 0)
    seq_shard = cache_seq_shard and shape.kind == "decode"
    rules = dict(DEFAULT_RULES)
    if not seq_sp:
        rules["seq_sp"] = ()
    t0 = time.time()
    with sharding_ctx(dm, rules=rules, fsdp=fsdp, seq_shard=seq_shard):
        pshapes, axes = tf.abstract_params(cfg)
        params = distribute_params(pshapes, axes)
        param_bytes = _local_bytes(params)
        opt_bytes = 0
        counter = OpCounter()
        if shape.kind == "train":
            opt = init_opt_state(params, AdamWConfig())
            opt_bytes = _local_bytes(opt.mu) + _local_bytes(opt.nu)
            batch = train_input_specs(arch, cfg, shape, dm)
            step = make_train_step(cfg, TrainConfig(remat=remat,
                                                    log_every=0))
            args = param_bytes + opt_bytes + _local_bytes(batch)
            with torch.enable_grad(), counter:
                step(params, opt, batch)
        elif shape.kind == "prefill":
            batch = train_input_specs(arch, cfg, shape, dm)
            batch.pop("labels")
            args = param_bytes + _local_bytes(batch)
            with torch.no_grad(), counter:
                tf.prefill(params, cfg, batch, shape.seq_len)
        else:
            state = tf.init_decode_state(cfg, shape.global_batch,
                                         shape.seq_len, device="meta")
            state = {sk: {bk: {n: distribute(t, NamedSharding(
                dm, _state_spec(n, t.shape, sizes, seq_shard)))
                for n, t in blk.items()} for bk, blk in sb.items()}
                for sk, sb in state.items()}
            batch, pos = decode_input_specs(arch, cfg, shape, dm)
            args = param_bytes + _local_bytes(state) + _local_bytes(batch)
            with torch.no_grad(), counter:
                tf.decode_step(params, cfg, state, batch, pos)
        t_count = time.time() - t0
        r = rf.analyze(counter, args)
    coll = dict(r.by_collective)
    coll["total"] = sum(coll.values())
    n_params = sum(t.numel() for t in _leaves(pshapes))
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh, "devices": n_dev,
        "kind": shape.kind, "fsdp": fsdp, "remat": remat,
        "tags": extra_tags, "layers": cfg.n_layers,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "n_params": n_params,
        "flops_per_device": r.flops,
        "bytes_per_device": r.bytes_accessed,
        "collective_bytes_per_device": r.collective_bytes,
        "collectives": coll,
        "n_collectives": len(counter.collectives),
        "arg_bytes_per_device": r.arg_bytes,
        "param_bytes_per_device": param_bytes,
        "opt_bytes_per_device": opt_bytes,
        "temp_bytes_per_device": r.temp_bytes,
        "t_compute": r.t_compute, "t_memory": r.t_memory,
        "t_collective": r.t_collective,
        "bottleneck": r.bottleneck,
        "roofline_fraction": r.fraction_of_roofline(),
        "flops_by_op": dict(counter.flops_by_op),
        "count_s": round(t_count, 1),
    }


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def lower_spc_cell(net_name: str, *, device: str = "cuda", seed: int = 0,
                   extent=(1024, 1024, 40), extra_tags: str = "") -> dict:
    """Count the paper's own workload for one card: one synthetic outdoor
    scene (``data/scenes.py``), its network plan and feature pass on
    ``device`` (scenes are per-card independent, so the natural
    deployment is one scene per card); the kernels by their closed
    forms."""
    from ..core import SparseTensor, build_network_plan
    from ..data import scenes
    from ..models import pointcloud as pc
    from ..serve.bucketing import bucket_capacity
    net = pc.NETWORKS[net_name](in_channels=4)
    sc = scenes.scene_batch(seed=seed, batch=1, kind="outdoor",
                            extent=extent, overlap=0.5)[0]
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn((len(sc.coords), 4), generator=gen)
    st = SparseTensor.from_point_clouds([(sc.coords, feats.numpy())],
                                        sc.layout, device=device)
    st = st.pad_to(bucket_capacity(len(sc.coords)))
    params = pc.init_pointcloud(net, seed=seed, device=device)
    counter = OpCounter()
    t0 = time.time()
    with torch.no_grad(), counter:
        plan = build_network_plan(st.packed, specs=net.conv_specs(),
                                  layout=st.layout)
        pc.pointcloud_forward(params, net, plan, st.features)
    r = rf.analyze(counter, _local_bytes(
        {k: v for k, v in params.state_dict().items()})
        + st.packed.numel() * st.packed.element_size()
        + st.features.numel() * st.features.element_size())
    return {
        "arch": f"spc-{net_name}", "shape": f"scene{extent[0]}",
        "mesh": "1x1", "devices": 1, "kind": "spc_infer",
        "tags": extra_tags, "device": str(device),
        "voxels": len(sc.coords),
        "n_params": sum(p.numel() for p in params.parameters()),
        "flops_per_device": r.flops, "bytes_per_device": r.bytes_accessed,
        "collective_bytes_per_device": r.collective_bytes,
        "collectives": {"total": r.collective_bytes},
        "arg_bytes_per_device": r.arg_bytes,
        "temp_bytes_per_device": r.temp_bytes,
        "t_compute": r.t_compute, "t_memory": r.t_memory,
        "t_collective": r.t_collective, "bottleneck": r.bottleneck,
        "roofline_fraction": r.fraction_of_roofline(),
        "flops_by_op": dict(counter.flops_by_op),
        "count_s": round(time.time() - t0, 1),
    }


def _load(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def _save(path: str, res: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)
    os.replace(path + ".tmp", path)


def cell_key(arch, shape, mesh, tags=""):
    k = f"{arch}|{shape}|{mesh}"
    return f"{k}|{tags}" if tags else k


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None,
                    help="1x1 (one H100), 16x16 or 2x16x16")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-seq-sp", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--tags", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--spc", default=None,
                    help="count a point-cloud network (sparse_resnet21 | "
                         "minkunet42 | centerpoint_large) instead of an LM")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh = args.mesh or ("2x16x16" if args.multi_pod else "16x16")

    if args.spc:
        key = cell_key(f"spc-{args.spc}", "scene1024", "1x1", args.tags)
        res = _load(args.out)
        if key in res and not args.force:
            print(f"[skip] {key}")
            return
        rec = lower_spc_cell(args.spc, device=args.device,
                             extra_tags=args.tags)
        res = _load(args.out)
        res[key] = rec
        _save(args.out, res)
        print(f"[ok] {key}: bottleneck={rec['bottleneck']} "
              f"t=({rec['t_compute']:.3e},{rec['t_memory']:.3e},"
              f"{rec['t_collective']:.3e})s", flush=True)
        return

    cells = []
    if args.all:
        for arch in configs.ARCHS:
            cfg = configs.get_config(arch)
            cells += [(arch, s) for s, sh in SHAPES.items()
                      if applicable(cfg, sh)]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    tags = args.tags or ",".join(
        f"{k}{v}" for k, v in (("layers", args.layers), ("batch",
                                                          args.batch),
                               ("seq", args.seq)) if v)
    res = _load(args.out)
    for arch, sname in cells:
        key = cell_key(arch, sname, mesh, tags)
        if key in res and not args.force:
            print(f"[skip] {key}")
            continue
        base = SHAPES[sname]
        shape = dataclasses.replace(
            base, seq_len=args.seq or base.seq_len,
            global_batch=args.batch or base.global_batch)
        print(f"[count] {key} ...", flush=True)
        try:
            rec = lower_cell(arch, sname, mesh=mesh, fsdp=not args.no_fsdp,
                             remat=not args.no_remat,
                             seq_sp=not args.no_seq_sp, extra_tags=tags,
                             layers=args.layers, shape=shape)
            mem = (rec["arg_bytes_per_device"]
                   + rec["temp_bytes_per_device"]) / 2**30
            print(f"[ok] {key}: n_params={rec['n_params']} "
                  f"bottleneck={rec['bottleneck']} "
                  f"t=({rec['t_compute']:.3e},{rec['t_memory']:.3e},"
                  f"{rec['t_collective']:.3e})s mem/dev={mem:.2f}GiB "
                  f"count={rec['count_s']}s", flush=True)
        except Exception as e:     # noqa: BLE001 — one cell's failure is
            traceback.print_exc()  # recorded, the others still run
            print(f"[FAIL] {key}: {e}")
            rec = {"arch": arch, "shape": sname, "mesh": mesh,
                   "error": str(e)[:2000]}
        res = _load(args.out)
        res[key] = rec
        _save(args.out, res)


if __name__ == "__main__":
    main()

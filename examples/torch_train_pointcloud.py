"""End-to-end point-cloud segmentation training through the session, on the
PyTorch port (``examples/train_pointcloud.py`` on ``repro_torch``).

Training
--------
The engine trains on the *transposed-map identity*: a kernel map is a
symmetric object — ``M[i, k] = j`` (output i reads input j through offset
δ_k) implies ``Mᵀ[j, mirror(k)] = i`` (input j's gradient reads output i's
through −δ_k). So the backward pass of every sparse convolution is the
*same dataflow run over the (mirror-scattered) forward kernel map*: for a
submanifold layer the transposed map IS the forward map, and for strided
layers one flat int32 scatter builds it (``core.kernel_map.
transpose_kernel_map``). **Zero kernel-map searches happen in the backward
pass**, and on the card the OS kernel (``csrc/spconv_gather_gemm.cu``)
serves the backward's dF too, the weight gradient runs the dW kernel
(``csrc/dw_gather_gemm.cu``) and BN, its backward and the loss the
segment-sum kernel (``csrc/segsum.cu``), so training never materializes
the ``[M, Kd, Cin]`` gathered intermediate in either direction.

The session owns the whole thing: ``session.compile_train()`` returns a
trainer whose step runs plan→forward→loss→grad→update per pow2 capacity
bucket (the same bucketing as inference), and updates the session's
params in place — the serving path and the training path share one
session and one set of weights.

    session = compile_network(net, layout, batch=B)
    trainer = session.compile_train()
    st, labels = labeled_batch(scene_batch(..., labels=True), session.layout)
    trainer.step(st, labels)          # loss/acc metrics; params updated
    session(st)                       # serve the trained weights

Run:  PYTHONPATH=src python examples/torch_train_pointcloud.py [--smoke]
      [--steps N] [--engine zdelta_cuda|zdelta|bsearch|hash]
      [--device cuda|cpu]      (cuda by default; there is no fallback)

``--smoke`` (the CI train-smoke stage) trains 30 steps of a tiny
submanifold segmentation net on synthetic labeled indoor scenes, asserts
the loss decreased, and round-trips params + optimizer state through
``ckpt.manager`` bit-exactly; the full run is MinkUNet-42 for 120 steps.
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.data import scenes
from repro_torch.models import pointcloud as pc
from repro_torch.serve import compile_network
from repro_torch.train import checkpoint_trees, init_opt_state
from repro_torch.train.pointcloud import PointCloudTrainConfig, labeled_batch


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny net / 30 steps / loss-decrease assert for CI")
    ap.add_argument("--steps", type=int, default=0,
                    help="override step count (default: 30 smoke, 120 full)")
    ap.add_argument("--engine", default="zdelta_cuda",
                    choices=["zdelta_cuda", "zdelta", "bsearch", "hash"])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    return args


def main(argv=None) -> dict:
    """Runs the example; returns its steady-state ms per step
    (``step_ms``) and the first and last metrics."""
    args = parse(argv)
    dev = args.device
    B = 2 if args.smoke else 4
    steps = args.steps or (30 if args.smoke else 120)
    extent = (48, 40, 24) if args.smoke else (64, 48, 24)
    n_classes = 8

    batch = scenes.scene_batch(seed=0, batch=B, kind="indoor", extent=extent,
                               labels=True, n_classes=n_classes)
    net = (pc.tiny_segnet(in_channels=4, n_classes=n_classes)
           if args.smoke else pc.minkunet42(in_channels=4,
                                            n_classes=n_classes))
    print(f"{net.name}: {len(net.specs)} SpC layers, {B} labeled {extent} "
          f"scenes, engine={args.engine}")

    session = compile_network(net, batch[0].layout, batch=B,
                              engine=args.engine, device=dev,
                              cuda_graphs=args.engine != "hash")
    tcfg = PointCloudTrainConfig()
    trainer = session.compile_train(tcfg)
    st, labels = labeled_batch(batch, session.layout, device=dev)
    print(f"batch: {int(st.count)} voxels in {st.capacity}-row buffer, "
          f"{n_classes} classes")

    t0 = time.perf_counter()
    m0 = trainer.step(st, labels)
    print(f"step 0 (first): loss {m0['loss']:.4f} acc {m0['accuracy']:.3f} "
          f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    m = m0
    for i in range(1, steps):
        m = trainer.step(st, labels)
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i}: loss {m['loss']:.4f} acc {m['accuracy']:.3f} "
                  f"gnorm {m['grad_norm']:.3f}")
    dt = (time.perf_counter() - t0) / max(steps - 1, 1)
    print(f"steady-state {dt * 1e3:.1f} ms/step, "
          f"compiled buckets: {trainer.compile_count}")

    assert m["loss"] < m0["loss"], (
        f"training did not reduce loss: {m0['loss']} -> {m['loss']}")
    print(f"loss {m0['loss']:.4f} -> {m['loss']:.4f} ✓ "
          f"(accuracy {m0['accuracy']:.3f} -> {m['accuracy']:.3f})")

    # checkpoint round-trip through ckpt.manager (atomic npz writes), into
    # a model and optimizer state of other values
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=False)
        mgr.save(steps, *checkpoint_trees(session.params, trainer.opt_state))
        model2 = pc.init_pointcloud(net, seed=1, device=dev)
        opt2 = init_opt_state(dict(model2.named_parameters()), tcfg.opt)
        _, _, at = mgr.restore(None, *checkpoint_trees(model2, opt2))
        for (k, a), b in zip(session.params.named_parameters(),
                             model2.parameters()):
            assert torch.equal(a, b), k
        for k in trainer.opt_state.mu:
            assert torch.equal(trainer.opt_state.mu[k], opt2.mu[k]), k
            assert torch.equal(trainer.opt_state.nu[k], opt2.nu[k]), k
        print(f"checkpoint round-trip at step {at}: params bit-exact ✓")

    # the same session serves the trained weights
    out = session(st)
    n = int(out.count)
    pred = out.features[:n].argmax(-1).cpu().numpy()
    ref = labels[:n].cpu().numpy()
    acc = float((pred == ref).mean())
    where = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"serving trained weights: {acc:.3f} accuracy on {n} voxels "
          f"({where})")
    return {"step_ms": dt * 1e3, "first": m0, "last": m,
            "serve_accuracy": acc}


if __name__ == "__main__":
    main()

"""Self-healing training end to end on the PyTorch port: poison quarantine
+ checkpoint recovery (``examples/robust_train.py`` on ``repro_torch``).

The demo drives one :class:`GuardedPointCloudTrainer` (``train.guard``)
through the full escalation ladder against injected faults
(``train.faults``) and proves the two acceptance equivalences of the
degraded-mode contract:

* **Skip path** — a run fed NaN-poisoned batches finishes with params
  BITWISE identical to a clean plain-trainer run over the healthy work
  alone (full healthy batches + the bisection sub-batches recorded on the
  TrainHealthReports); the poison's only trace is the quarantine log.
* **Fallback path** — after the newest on-disk checkpoint is corrupted
  (silent byte flip, container-consistent: only the manifest's CRC32 can
  see it), a "restarted process" resumes from the newest checkpoint that
  VERIFIES and continues bitwise on the uninterrupted run's trajectory.

Every defensive decision is visible in the counters dict (skips,
bisections, quarantined scenes, checksum failures, the last_good anchor).
On the card each step runs the superwindow search, the OS kernel forward
and dF, dW and the segment sums.

The port's bisection starts at the halves: it skips the reference's
second attempt of the whole refused batch, which can only be refused
again. Counters, reports and committed updates are the reference's; the
``train/step`` and ``train/pack`` spans count one fewer per bisection, which
the ``>= steps`` assert below allows as the reference's does.

Run:  PYTHONPATH=src python examples/torch_robust_train.py [--smoke]
      [--steps N] [--device cuda|cpu]  (cuda by default; no fallback)

``--smoke`` (the CI train-robustness stage) is the same demo on a tiny
net; both modes assert, so a silent regression fails the run.
"""
import argparse
import copy
import json
import tempfile
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.data import scenes
from repro_torch.models import pointcloud as pc
from repro_torch.obs import parse_prometheus_text
from repro_torch.serve import compile_network
from repro_torch.train import GuardConfig, labeled_batch, labeled_tensor
from repro_torch.train import faults as tf
from repro_torch.train.pointcloud import scene_features


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny net / few steps / assert-everything for CI")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    return args


def tree_bytes(model):
    return [p.detach().cpu().numpy().tobytes() for p in model.parameters()]


def main(argv=None) -> dict:
    """Runs the example; returns the poisoned run's seconds and steps."""
    args = parse(argv)
    dev = args.device
    B = 3
    steps = args.steps or (8 if args.smoke else 24)
    extent = (32, 28, 16) if args.smoke else (48, 40, 24)
    n_classes = 6
    width, depth = (8, 3) if args.smoke else (16, 4)

    sb = scenes.scene_batch(seed=0, batch=B, kind="indoor", extent=extent,
                            labels=True, n_classes=n_classes)
    net = pc.tiny_segnet(in_channels=4, n_classes=n_classes, width=width,
                         depth=depth)
    print(f"{net.name}: {len(net.specs)} SpC layers, {B} labeled {extent} "
          f"scenes, {steps} steps")

    session = compile_network(net, sb[0].layout, batch=B, device=dev)
    p0 = copy.deepcopy(session.params)  # the trainer updates in place
    st, lab = labeled_batch(sb, session.layout, device=dev)

    with tempfile.TemporaryDirectory() as ckdir:
        # the manager shares the session's registry, so step-phase timings,
        # guard counters and checkpoint bytes export from one surface
        mgr = CheckpointManager(ckdir, keep=10, async_save=False,
                                metrics=session.metrics)
        guard = GuardConfig(ckpt_every=1, last_good_after=1)
        trainer = session.compile_train(guard=guard, ckpt=mgr)

        # -- poisoned run: NaN batches on a schedule ------------------------
        poisoned_at = {2: 1, 5: 0}            # step index -> poisoned scene
        t0 = time.perf_counter()
        reports, snapshots = [], {}
        for i in range(steps):
            x = (tf.poison_scene_nonfinite(st, poisoned_at[i])
                 if i in poisoned_at else st)
            m = trainer.step(x, lab)
            mgr.wait()
            reports.append(trainer.last_report)
            snapshots[int(trainer.opt_state.step)] = tree_bytes(
                session.params)
            tag = "" if trainer.last_report.ok else \
                f"   <- {trainer.last_report.summary()}"
            print(f"step {i}: loss {m['loss']:.4f} "
                  f"ok={int(m['step_ok'])}{tag}")
        run_s = time.perf_counter() - t0
        print(f"poisoned run: {run_s:.1f}s, counters: {trainer.counters}")
        c = trainer.counters
        assert c["nonfinite_steps"] == len(poisoned_at)
        assert c["scenes_quarantined"] == len(poisoned_at)
        assert c["bisections"] == len(poisoned_at)

        # -- skip path: bitwise equivalence with the clean run --------------
        s2 = compile_network(net, session.layout, batch=B,
                             params=copy.deepcopy(p0), device=dev)
        clean = s2.compile_train()            # PLAIN trainer, no guard
        clouds = [(sc.coords, scene_features(sc), sc.labels) for sc in sb]
        for r in reports:
            for grp in r.committed:
                if grp is None:
                    clean.step(st, lab)
                else:
                    sst, slab = labeled_tensor([clouds[i] for i in grp],
                                               s2.layout, device=dev)
                    clean.step(sst, slab)
        assert tree_bytes(session.params) == tree_bytes(s2.params), \
            "guarded run != clean run on the healthy work"
        print(f"skip path: params bitwise == clean run over healthy work "
              f"alone ({sum(len(r.committed) for r in reports)} commits) ✓")

        # -- fallback path: corrupt the newest checkpoint, resume -----------
        last = mgr.latest_step()
        tf.corrupt_checkpoint(ckdir, last, mode="flip")
        s3 = compile_network(net, session.layout, batch=B,
                             params=copy.deepcopy(p0), device=dev)
        mgr2 = CheckpointManager(ckdir, async_save=False)
        tr3 = s3.compile_train(guard=True, ckpt=mgr2, resume=True)
        got = int(tr3.opt_state.step)
        assert got == last - 1, (got, last)
        assert tree_bytes(s3.params) == snapshots[got], \
            "resumed params != the uninterrupted run at that step"
        assert tr3.counters["checksum_failures"] == 1
        print(f"fallback path: ckpt_{last:08d}.npz corrupted -> resumed at "
              f"step {got} (newest verifying), params bitwise == "
              f"uninterrupted run ✓  "
              f"(checksum_failures={tr3.counters['checksum_failures']})")

        # the resumed run continues on the same trajectory
        tr3.step(st, lab)
        assert tree_bytes(s3.params) == snapshots[last], \
            "post-resume step diverged from the uninterrupted trajectory"
        where = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
        print(f"post-resume step bitwise == uninterrupted step {last} ✓ "
              f"({where})")

        # -- observability: train + ckpt metrics on one registry ------------
        reg = session.metrics
        snap = reg.snapshot()
        assert json.loads(json.dumps(snap)) == snap, \
            "snapshot must round-trip JSON"
        assert snap["counters"]["train_steps_total"] == steps
        assert snap["counters"]["train_nonfinite_steps"] == len(poisoned_at)
        assert snap["counters"]["ckpt_bytes_written"] > 0
        assert snap["histograms"]["train/step"]["count"] >= steps
        assert snap["histograms"]["ckpt/save"]["count"] == \
            trainer.counters["checkpoint_saves"]
        samples = parse_prometheus_text(reg.to_prometheus_text())  # raises
        assert "spira_train_steps_total" in samples
        assert "spira_ckpt_save_bucket" in samples
        print(f"metrics: {len(samples)} prometheus series, snapshot "
              f"round-trips, ckpt bytes="
              f"{snap['counters']['ckpt_bytes_written']} ✓")
    return {"run_s": run_s, "steps": steps}


if __name__ == "__main__":
    main()

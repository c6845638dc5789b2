"""Fault-isolated serving on the PyTorch port: degraded-mode outcomes and
overflow escalation (``examples/robust_serve.py`` on ``repro_torch``).

Mixed traffic hits one engine: clean scenes, a scene whose coordinates
violate the packing contract (rejected at ingest), a scene carrying a
request-borne fault that only shows inside the session (quarantined by
bisection), a request whose deadline has already passed (dropped at
submit), and one over the bounded queue (shed at submit). The engine
serves every innocent request bitwise identically to a clean run and
finalizes every faulty one with a structured outcome — nothing raises,
nothing is lost.

Then the overflow-escalation path: a session whose WS layer capacity is
tuned too small for the scene replans at the next escalation level and
returns logits bitwise equal to the lossless network's, with the replan
visible in the HealthReport.

The end of the run asserts the observability contract
(``repro_torch.obs``): all engines above recorded onto the shared session
registry, its JSON snapshot round-trips, and the Prometheus text export
parses.

Run:  PYTHONPATH=src python examples/torch_robust_serve.py [--smoke]
      [--device cuda|cpu]      (cuda by default; there is no fallback)
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.core import SparseTensor, SpConvSpec
from repro_torch.data import scenes
from repro_torch.models.pointcloud import PointCloudNet
from repro_torch.obs import parse_prometheus_text
from repro_torch.serve import (FaultySession, PointCloudRequest,
                               PointCloudServeEngine, compile_network,
                               feature_poison, poison_coords, poison_features)

B = 4


def make_net(ws_capacity=None):
    # l0 is weight-stationary so the escalation demo compares a capped
    # session against the lossless one within a single dataflow
    specs = (
        SpConvSpec("l0", 4, 8, K=3, m_in=0, m_out=0, dataflow="ws",
                   ws_capacity=ws_capacity),
        SpConvSpec("l1", 8, 8, K=3, m_in=0, m_out=1),
        SpConvSpec("l2", 8, 8, K=3, m_in=1, m_out=1),
    )
    return PointCloudNet("robust_demo", specs, in_channels=4, n_classes=5)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    dev = args.device
    extent = (28, 24, 16) if args.smoke else (48, 40, 24)

    pool = scenes.scene_batch(seed=11, batch=6, kind="indoor", extent=extent,
                              overlap=0.4)
    layout = pool[0].layout
    rng = np.random.default_rng(11)
    clouds = [(sc.coords,
               rng.normal(size=(len(sc.coords), 4)).astype(np.float32))
              for sc in pool]

    session = compile_network(make_net(), layout, batch=B, min_bucket=128,
                              device=dev)

    # --- clean reference run (for the bitwise-isolation check below) ------
    ref = [PointCloudRequest(c, f.copy()) for c, f in clouds]
    PointCloudServeEngine(session).run(ref)
    assert all(r.outcome == "ok" for r in ref)

    # --- mixed faulty traffic through one fault-injected engine -----------
    traffic = [(c, f.copy()) for c, f in clouds]
    traffic[1] = (poison_coords(traffic[1][0], layout), traffic[1][1])
    traffic[3] = (traffic[3][0], poison_features(traffic[3][1]))
    reqs = [PointCloudRequest(c, f) for c, f in traffic]
    reqs[4].deadline = 0.0      # already in the past: expires at submit,
                                # never occupying a queue slot

    eng = PointCloudServeEngine(
        FaultySession(session, poison=feature_poison()),
        max_queue=len(reqs) - 2)    # bounded queue: the last submit sheds
    eng.run(reqs)                   # never raises

    for i, r in enumerate(reqs):
        note = (f" [{(r.error or '').splitlines()[0][:60]}]" if r.error
                else "")
        print(f"request {i}: {r.outcome}{note}")

    want = ["ok", "invalid", "ok", "quarantined", "deadline_expired", "shed"]
    assert [r.outcome for r in reqs] == want, [r.outcome for r in reqs]
    for i in (0, 2):            # innocents: bitwise equal to the clean run
        np.testing.assert_array_equal(reqs[i].logits, ref[i].logits)
        np.testing.assert_array_equal(reqs[i].voxels, ref[i].voxels)
    print("innocent requests bitwise equal to the clean run ✓")
    print(f"counters: {eng.counters}")

    # --- transient fault: retried with capped backoff, not fatal ----------
    flaky = PointCloudServeEngine(FaultySession(session, fail_calls={0}))
    reqs2 = [PointCloudRequest(c, f.copy()) for c, f in clouds[:B]]
    flaky.run(reqs2)
    assert all(r.outcome == "ok" for r in reqs2)
    assert flaky.retries == 1
    np.testing.assert_array_equal(reqs2[0].logits, ref[0].logits)
    print(f"transient device fault retried ({flaky.retries} retry) and "
          "served ✓")

    # --- overflow escalation: replan instead of silent truncation ---------
    st = SparseTensor.from_point_cloud(*clouds[0], session.layout,
                                       device=dev)
    out_ref, h_ref = session.run_with_health(st)
    assert h_ref.ok and h_ref.replans == 0

    m = session.plan(st).kmaps["l0"].m
    demand = int((m >= 0).sum(dim=0).max())     # real pair demand per column
    cap = (demand + 1) // 2                     # tuned to half: overflows
    capped = compile_network(make_net(ws_capacity=cap), layout, batch=B,
                             min_bucket=128, params=session.params,
                             device=dev)
    out, health = capped.run_with_health(st)
    print(f"ws_capacity={cap} vs demand {demand}: {health.summary()}")
    assert health.replans == 1 and health.ok
    n = int(out_ref.count)
    assert torch.equal(out.features[:n], out_ref.features[:n])
    print("escalated output bitwise equal to lossless ✓")

    # --- observability: every engine above fed one shared registry ---------
    reg = session.metrics
    assert eng.metrics is reg and flaky.metrics is reg  # FaultySession proxy
    snap = reg.snapshot()
    assert json.loads(json.dumps(snap)) == snap, "snapshot must round-trip"
    # histograms accumulate across all engines; the faulty traffic is in
    assert snap["histograms"]["serve_latency_ok"]["count"] >= 2 * B
    assert "serve/pack" in snap["histograms"]
    assert "serve/dispatch" in snap["histograms"]
    assert snap["counters"]["serve_retries"] == 1          # the flaky one's
    assert snap["counters"]["session_runs"] >= 1
    samples = parse_prometheus_text(reg.to_prometheus_text())  # raises if bad
    assert "spira_serve_admitted" in samples
    assert "spira_serve_latency_ok_bucket" in samples
    print(f"metrics: {len(samples)} prometheus series, snapshot round-trips, "
          f"qps(60s)={snap['rates']['serve_qps']:.2f} ✓")


if __name__ == "__main__":
    main()

"""Overload-robust serving on the PyTorch port: three scripted scenarios,
each replayed deterministically on a FakeClock and asserted EXACTLY
(``examples/overload_serve.py`` on ``repro_torch``). The sessions run on
the card; only the engine's clock is fake, so the outcome mix is the same
arithmetic on every machine.

Scenario 1 — 2× sustained overload. Arrivals at twice the engine's
service capacity (capacity = batch / injected service time). Adaptive
admission (CoDel on observed queue delay) sheds the excess at submit, the
degradation ladder engages, queue delay stays bounded, goodput stays
nonzero, and every served request is BITWISE identical to an unloaded
run.

Scenario 2 — breaker trip + recovery. A scripted burst of non-transient
dispatch failures trips the circuit breaker (closed → open); queued
traffic fails fast as ``rejected_open`` with zero session calls; after
the cooldown a half-open probe succeeds and closes it again.

Scenario 3 — degradation ladder walk. Sustained pressure steps the
engine through tight-max-wait → no-escalation → voxel-budget
downsampling (an oversized scene is decimated to the budget), then
pressure clears and the engine steps back down to healthy.

Run:  PYTHONPATH=src python examples/torch_overload_serve.py [--smoke]
      [--device cuda|cpu]      (cuda by default; there is no fallback)
"""
import argparse

import numpy as np
import torch

from repro_torch.core import SpConvSpec
from repro_torch.data import scenes
from repro_torch.models.pointcloud import PointCloudNet
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import (AdmissionConfig, BreakerConfig, FakeClock,
                               FaultySession, LadderConfig,
                               PointCloudRequest, PointCloudServeEngine,
                               arrival_times, compile_network, make_traffic,
                               run_open_loop)

B = 4


def make_net():
    specs = (
        SpConvSpec("l0", 4, 8, K=3, m_in=0, m_out=0, dataflow="ws"),
        SpConvSpec("l1", 8, 8, K=3, m_in=0, m_out=1),
        SpConvSpec("l2", 8, 8, K=3, m_in=1, m_out=1),
    )
    return PointCloudNet("overload_demo", specs, in_channels=4, n_classes=5)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run on the CPU)")
    extent = (28, 24, 16) if args.smoke else (48, 40, 24)

    pool = scenes.scene_batch(seed=7, batch=4, kind="indoor", extent=extent,
                              overlap=0.5)
    layout = pool[0].layout
    rng = np.random.default_rng(7)
    clouds = [(sc.coords,
               rng.normal(size=(len(sc.coords), 4)).astype(np.float32))
              for sc in pool]

    ck = FakeClock()
    reg = MetricsRegistry(clock=ck)
    session = compile_network(make_net(), layout, batch=B, min_bucket=128,
                              metrics=reg, device=args.device)

    # unloaded reference for the bitwise check
    ref = [PointCloudRequest(c, f.copy()) for c, f in clouds]
    PointCloudServeEngine(session).run(ref)
    assert all(r.outcome == "ok" for r in ref)

    # --- scenario 1: 2x sustained overload ---------------------------------
    # service time 0.1s/dispatch -> capacity 40 scenes/s; offer 80/s, 40 reqs
    N = 40
    fs = FaultySession(session, delay=0.1, sleep=ck.sleep)
    eng = PointCloudServeEngine(
        fs, clock=ck, max_queue=8,
        admission=AdmissionConfig(target=0.05, interval=0.2),
        ladder=LadderConfig(target=0.05, escalate_after=0.2,
                            deescalate_after=0.5, voxel_budget=1 << 20))
    reqs = make_traffic(clouds, N)
    rep = run_open_loop(eng, list(zip(arrival_times(N, rate=80.0), reqs)),
                        ck)
    print(f"2x overload: {rep.summary()}")

    assert rep.outcomes == {"ok": 25, "shed": 15}, rep.outcomes  # exact mix
    assert eng.admission_shed == 1 and eng.shed == 15     # CoDel + backstop
    assert rep.goodput > 0 and rep.max_queue_depth <= 8
    assert rep.p99_queue_wait <= 0.5                      # bounded delay
    assert rep.max_rung >= 1 and eng.degradations >= 1    # ladder engaged
    for i, r in enumerate(reqs):
        if r.outcome == "ok":               # served == unloaded run, bitwise
            want = ref[i % len(clouds)]
            np.testing.assert_array_equal(r.logits, want.logits)
            np.testing.assert_array_equal(r.voxels, want.voxels)
    print("served-under-overload answers bitwise equal to the unloaded "
          "run ✓")

    # --- scenario 2: breaker trip + recovery --------------------------------
    fs2 = FaultySession(session, fail_calls={0, 1}, exc=RuntimeError)
    eng2 = PointCloudServeEngine(
        fs2, max_batch=1, clock=ck,
        breaker=BreakerConfig(threshold=2, cooldown=1.0))
    burst = make_traffic(clouds, 7)
    for r in burst[:2]:                     # scripted fault burst: trip
        eng2.submit(r)
        eng2.step()
    for r in burst[2:5]:                    # open: fail fast, no session call
        eng2.submit(r)
        eng2.step()
    calls_while_open = fs2.calls
    ck.advance(1.5)                         # cooldown -> half-open probe
    for r in burst[5:]:
        eng2.submit(r)
        eng2.step()

    mix2 = {}
    for r in burst:
        mix2[r.outcome] = mix2.get(r.outcome, 0) + 1
    print(f"breaker: {mix2}, trips={eng2.breaker_trips}, "
          f"state={reg.gauge('serve_breaker_state').value:.0f}")
    assert mix2 == {"quarantined": 2, "rejected_open": 3, "ok": 2}, mix2
    assert calls_while_open == 2            # the open breaker burned nothing
    assert eng2.breaker_trips == 1 and eng2.rejected_open == 3
    assert reg.gauge("serve_breaker_state").value == 0     # closed again
    np.testing.assert_array_equal(burst[5].logits, ref[1].logits)
    print("breaker tripped on the fault burst and recovered via half-open ✓")

    # --- scenario 3: degradation ladder walk --------------------------------
    budget = 128
    fs3 = FaultySession(session, delay=0.3, sleep=ck.sleep)
    eng3 = PointCloudServeEngine(
        fs3, max_batch=2, clock=ck,
        ladder=LadderConfig(target=0.05, escalate_after=0.25,
                            deescalate_after=0.5, voxel_budget=budget))
    rungs = []
    heavy = make_traffic(clouds, 12)
    for r in heavy:
        eng3.submit(r)
    while eng3.pending:                     # 0.3s/batch-of-2: waits pile up
        eng3.step()
        rungs.append(eng3.degradation_rung)
    walked = sorted(set(rungs))
    print(f"ladder walk under pressure: rungs seen {walked}, "
          f"downsampled={eng3.downsampled}")
    assert walked == [0, 1, 2, 3]           # every rung, in order
    assert rungs == sorted(rungs)           # monotone while pressure builds
    assert eng3.downsampled > 0             # rung 3 decimated big scenes
    down = [r for r in heavy if r.downsampled]
    assert all(len(r.coords) == budget and r.degradation == 3 for r in down)
    assert all(r.outcome == "ok" for r in heavy)
    # healthy (non-downsampled) requests: still bitwise, even at rung >= 1
    for i, r in enumerate(heavy):
        if not r.downsampled:
            np.testing.assert_array_equal(r.logits,
                                          ref[i % len(clouds)].logits)
    # pressure clears: idle waits under target step the engine back down
    calm = make_traffic(clouds, 8)
    for r in calm:
        eng3.submit(r)
        eng3.step()
        ck.advance(0.2)                     # headroom between arrivals
        eng3.step()
    assert eng3.degradation_rung == 0       # fully de-escalated
    print(f"pressure cleared: engine stepped back to rung 0 "
          f"(escalations={eng3.degradations}) ✓")

    print(f"counters (ladder engine): {eng3.counters}")
    print("torch_overload_serve: OK")


if __name__ == "__main__":
    main()

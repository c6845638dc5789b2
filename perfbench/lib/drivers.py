"""The three loops a mix can ask for (``mix["loop"]``): ``closed`` offline
inference, ``open`` online requests at seeded Poisson arrivals, ``train``
training steps. Each builds the program's objects, warms up every shape
its traffic uses (set-up), measures for the window, and returns a
``Record`` (what the window did and the answers kept for the check) and
the program's objects, which the caller frees before the check."""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import system

now = time.perf_counter


@dataclasses.dataclass
class Record:
    t0: float                       # window start (host clock)
    window_s: float
    calls: List[int]                # pool entry of each call in the window
    scenes: int
    attempted: int
    failed: int = 0
    latencies: List[float] = dataclasses.field(default_factory=list)
    backlog: Dict[str, float] = dataclasses.field(default_factory=dict)
    kept: list = dataclasses.field(default_factory=list)
    health: Dict[str, int] = dataclasses.field(default_factory=dict)
    train: Optional[dict] = None    # the first steps' readings
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _health(acc: dict, h, bucket: int) -> None:
    """Fold one call's health report: dropped pairs, escalations and calls
    off their expected bucket, each summed over the window."""
    acc["dropped_pairs"] = acc.get("dropped_pairs", 0) + h.total_ws_dropped
    acc["escalations"] = acc.get("escalations", 0) + h.escalation + h.replans
    acc["bucket_mismatch"] = acc.get("bucket_mismatch", 0) + int(
        h.bucket != bucket)


def bucket(voxels: int, min_bucket: int = 1024) -> int:
    """The power-of-two capacity a session should pick for a call."""
    cap = min_bucket
    while cap < voxels:
        cap <<= 1
    return cap


def _session(env):
    """The program's session over a copy of the benchmark's weights."""
    return system.session(env.cfg, env.net, system.model(env.net, env.weights),
                          env.mix["extent"], env.mix["scenes_per_call"],
                          env.device)


def _answer(out) -> tuple:
    """A call's answer on the host: output words and logits of its rows."""
    n = int(out.count)
    return out.packed[:n].cpu(), out.features[:n].cpu()


def closed(env) -> tuple:
    """One caller; each call is the next batch of the pool, cycled."""
    mix, tr = env.mix, env.tracer
    sess = _session(env)
    hosts = [system.pack(sess, b) for b in env.pool]
    buckets = [bucket(b.voxels) for b in env.pool]
    for _ in range(mix["warmup_rounds"]):
        for st in hosts:
            sess.run_with_health(st)
    _sync(env.device)
    P = len(hosts)
    rng = np.random.default_rng([env.seed, 1])
    early = rng.integers(0, mix["sample_within"], size=P)
    kept, last, health, calls = {}, {}, {}, []
    with tr, tr.range("bench/window"):
        t0 = now()
        t_end = t0 + env.seconds
        i = 0
        while now() < t_end:
            b = i % P
            with tr.range("bench/call"):
                out, h = sess.run_with_health(hosts[b])
            _health(health, h, buckets[b])
            if i // P == early[b]:
                kept[(b, i)] = out
            last[b] = (i, out)
            calls.append(b)
            i += 1
        _sync(env.device)
        t1 = now()
    for b, (i, out) in last.items():
        kept[(b, i)] = out
    answers = [(b, *_answer(out)) for (b, i), out in sorted(kept.items())]
    return Record(t0, t1 - t0, calls, len(calls) * mix["scenes_per_call"],
                  attempted=len(calls), kept=answers, health=health), sess


def open_loop(env) -> tuple:
    """Requests of one scene each at Poisson arrivals (a fixed schedule from
    the mix's own seed, the same for every run), each served by one call
    in arrival order; a request is timed from its due time to its answer on
    the host. The schedule starts ``preroll_s`` before the window, so the
    queue is in its steady state when the window opens; the pre-roll's
    requests are served, and neither timed nor checked. Requests due in the
    window are all served; one not answered ``drain_s`` after the window's
    end counts as failed."""
    mix, tr = env.mix, env.tracer
    sess = _session(env)
    hosts = [system.pack(sess, b) for b in env.pool]
    buckets = [bucket(b.voxels) for b in env.pool]
    for _ in range(mix["warmup_rounds"]):
        for st in hosts:
            _answer(sess.run_with_health(st)[0])
    _sync(env.device)
    pre, due = arrivals(mix, env.seconds, env.rate)
    rng = np.random.default_rng([env.seed, 2])
    which = rng.integers(0, len(hosts), size=len(pre) + len(due))
    sample = set(rng.choice(len(due), size=min(mix["sample"], len(due)),
                            replace=False).tolist()) | {len(due) - 1}

    def serve(d, b):
        """Wait for the request due at ``d``, then serve it; returns when
        its call began, its answer and its health report."""
        target = t0 + d
        wait = target - now()
        if wait > 0:
            with tr.range("bench/wait"):
                if wait > 2e-3:
                    time.sleep(wait - 1e-3)
                while now() < target:
                    pass
        began = now()
        with tr.range("bench/call"):
            out, h = sess.run_with_health(hosts[b])
        with tr.range("bench/answer"):
            return began, _answer(out), h

    health, lat, kept, began = {}, [], [], []
    # a traced run starts its profiler before the pre-roll, so that the
    # profiler's start-up delays no request of the window
    with tr:
        t0 = now() + mix["preroll_s"] + 0.01
        stop = t0 + env.seconds + mix["drain_s"]
        for d, b in zip(pre, which):
            serve(d, int(b))
        c0 = system.call_span(sess)
        with tr.range("bench/window"):
            for i, d in enumerate(due):
                if now() > stop:
                    break
                b = int(which[len(pre) + i])
                t, ans, h = serve(d, b)
                lat.append(now() - (t0 + d))
                began.append(t - t0)
                _health(health, h, buckets[b])
                if i in sample:
                    kept.append((b, *ans))
            _sync(env.device)
            t1 = now()
    c1 = system.call_span(sess)
    calls = [int(b) for b in which[len(pre):len(pre) + len(lat)]]
    return Record(t0, t1 - t0, calls, len(lat), attempted=len(due),
                  failed=len(due) - len(lat), latencies=lat,
                  backlog=backlog(due, began, env.seconds),
                  kept=kept, health=health,
                  counters={"call_count": c1[0] - c0[0],
                            "call_seconds": c1[1] - c0[1]}), sess


def backlog(due, began, seconds: float) -> Dict[str, float]:
    """Requests due and not yet begun at the window's middle and at its end
    (one never begun counts as waiting), and the longest wait of a served
    request before its call began: a backlog that grows from the middle to
    the end is load over capacity."""
    began = list(began) + [math.inf] * (len(due) - len(began))

    def waiting(t):
        return sum(1 for d, b in zip(due, began) if d <= t < b)
    return {"backlog_mid": waiting(seconds / 2),
            "backlog_end": waiting(seconds),
            "max_wait_s": max((b - d for d, b in zip(due, began)
                               if b < math.inf), default=0.0)}


def arrivals(mix: dict, seconds: float, rate: Optional[float] = None
             ) -> tuple:
    """Due times (s from the window's start) of the pre-roll and of the
    window: Poisson arrivals at ``rate`` (default the mix's) conditioned on
    their count, so that each span offers exactly the rate (``round(rate x
    span)`` times, uniform in the span and sorted), from the mix's arrival
    seed. The window's times do not depend on the pre-roll's length."""
    rate = rate or mix["rate"]

    def span(lo, hi, key):
        rng = np.random.default_rng([mix["arrival_seed"], key])
        return np.sort(rng.uniform(lo, hi, size=int(round(rate * (hi - lo)))))
    return span(-mix.get("preroll_s", 0.0), 0.0, 1), span(0.0, seconds, 0)


def train(env) -> tuple:
    """Training steps; each step is the next labelled batch of the pool.
    Set-up drives the trainer through its first steps on distinct batches
    and keeps what the check compares: each step's loss, every leaf's
    first gradient as the optimizer took it (its first moment after one
    step over ``1 - b1``) and every leaf's change over those steps."""
    mix, tr = env.mix, env.tracer
    sess = _session(env)
    trainer = system.trainer(sess, mix["opt"])
    hosts = [system.pack_labeled(sess, b) for b in env.pool]
    named = dict(sess.params.named_parameters())
    p0 = {k: v.detach().clone() for k, v in named.items()}
    n_check = mix["checked_steps"]
    losses, grad = [], None
    for j in range(n_check):
        losses.append(trainer.step(*hosts[j])["loss"])
        if j == 0:
            b1 = mix["opt"]["b1"]
            grad = {k: float(torch.linalg.vector_norm(
                trainer.opt_state.mu[k].double())) / (1 - b1) for k in named}
    change = {k: float(torch.linalg.vector_norm(
        (v.detach() - p0[k]).double())) for k, v in named.items()}
    del p0
    _sync(env.device)
    P = len(hosts)
    calls, failed = [], 0
    with tr, tr.range("bench/window"):
        t0 = now()
        t_end = t0 + env.seconds
        j = n_check
        while now() < t_end:
            b = j % P
            with tr.range("bench/step"):
                m = trainer.step(*hosts[b])
            failed += not math.isfinite(m["loss"])
            calls.append(b)
            j += 1
        _sync(env.device)
        t1 = now()
    return Record(t0, t1 - t0, calls, len(calls) * mix["scenes_per_call"],
                  attempted=len(calls), failed=failed,
                  train={"losses": losses, "grad": grad, "change": change}
                  ), (sess, trainer)


LOOPS = {"closed": closed, "open": open_loop, "train": train}

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``, imports nothing of JAX or of the
JAX package, and exits nonzero (printing no result) when there is no card
or when it is not run from a checkout of the repository. Phases, each
printing its lines; any failed check raises and the exit code is nonzero:

1. device: torch version, card name and ``nvidia-smi`` power limit; TF32
   off (the port sets it on import);
2. build: compile ``src/repro_torch/csrc/*.cu`` with nvcc, timed;
3. kernels vs plain versions on the card, at the shapes of the main path:
   every launch of one batch-of-2 forward is recorded and re-run through
   the kernel and its plain PyTorch version — superwindow maps and
   overflow counters equal, segment sums bitwise, OS within
   ``1e-5 * max(1, max|ref|)`` in fp32 (and ``2e-2`` relative in bf16 at
   the stem, a 256->256 layer and an up-conv); each timed with CUDA events
   beside its plain version, its bound and the library yardstick;
4. main path: MinkUNet-42 at full width through ``compile_network`` ->
   ``SpiraSession`` on two outdoor LiDAR-sized scenes — scene 0 alone,
   then the batch of 2, each twice — checking finite logits, batched
   scene 0 bitwise equal to the single run, one compiled key per bucket,
   and 42 launches of each kernel per call; then one more batch-of-2
   call under ``torch.profiler`` for the device's busy share and its
   time by kernel;
5. the same session on the plain path (engine "zdelta", backends "torch")
   on the same card: kernel maps equal, logits within
   ``1e-3 * max|logits|``.

The second-to-last lines are the kernel table as JSON and the raw
``nvidia-smi --query-gpu=name,power.limit`` line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12         # H100 SXM fp32, CUDA cores
REPLACES = {
    "zdelta_superwindow_search": ("src/repro_torch/csrc/zdelta_superwindow.cu",
                                  "src/repro/kernels/zdelta_window.py:246"),
    "spconv_gather_gemm": ("src/repro_torch/csrc/spconv_gather_gemm.cu",
                           "src/repro/kernels/spconv_gather_gemm.py:97"),
    "segment_sum": ("src/repro_torch/csrc/segsum.cu",
                    "src/repro/kernels/segsum.py:252"),
}


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the card: one warm-up, then ``reps``
    calls between two CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def short_kernel_name(name: str) -> str:
    """A device kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.removeprefix("void ").strip()[:72]


def profile_call(fn) -> tuple[float, dict]:
    """Run ``fn`` once under ``torch.profiler``: its wall ms (host clock,
    synchronised) and the device ms of every kernel and copy, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = short_kernel_name(e.name)
            by_name[k] = by_name.get(k, 0.0) + e.device_time_total / 1e3
    return wall, by_name


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Recorder:
    """Records the arguments of every kernel launch of one forward by
    wrapping the launching functions where the dispatchers look them up."""

    def __init__(self):
        from repro_torch.kernels import ops, segsum, zdelta_window
        self.targets = [(zdelta_window, "zdelta_superwindow_cuda",
                         "zdelta_superwindow_search"),
                        (ops, "spconv_gather_gemm", "spconv_gather_gemm"),
                        (segsum, "segment_sum_cuda", "segment_sum")]
        self.calls = {name: [] for _, _, name in self.targets}

    def __enter__(self):
        self.saved = []
        for mod, attr, name in self.targets:
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))

            def wrapped(*a, _orig=orig, _name=name, **kw):
                self.calls[_name].append((a, kw))
                return _orig(*a, **kw)
            # the launchers count on the function their module binds
            wrapped.launches = getattr(orig, "launches", 0)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)
        return False


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)    # inference only: no autograd graphs
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.core.sparse_tensor import SparseTensor
    from repro_torch.data import scenes
    from repro_torch.kernels import (_build, launch_counts,
                                     reset_launch_counts)
    from repro_torch.kernels.segsum import segment_sum_torch
    from repro_torch.kernels.spconv_gather_gemm import (
        spconv_gather_gemm, spconv_gather_gemm_torch)
    from repro_torch.kernels.zdelta_window import (zdelta_superwindow_cuda,
                                                   zdelta_superwindow_torch)
    from repro_torch.kernels import segsum as segsum_mod
    from repro_torch.models import pointcloud as pc
    from repro_torch.serve import bucket_capacity, compile_network
    if "jax" in sys.modules or "repro" in sys.modules:
        raise RuntimeError("the port must not load jax or the JAX package")

    # -- 1. device ---------------------------------------------------------
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on; the reference contract is IEEE fp32")
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{kind} | nvidia-smi: {card} | devices {torch.cuda.device_count()} "
        f"| tf32 off")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[2 build] {len(_build.sources())} sources -> {lib.name} in "
        f"{time.perf_counter() - t0:.2f} s")
    ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text()
             .splitlines() if "registers" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        log(f"    ptxas {ln}")

    # -- the main path's inputs -------------------------------------------
    t0 = time.perf_counter()
    batch = scenes.scene_batch(seed=0, batch=2, kind="outdoor",
                               extent=(1024, 1024, 40), overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), 4))
               .astype(np.float32)) for sc in batch]
    sizes = [len(c) for c, _ in clouds]
    net = pc.minkunet42(in_channels=4, n_classes=20)
    session = compile_network(net, batch[0].layout, batch=2, seed=0)
    st1 = SparseTensor.from_point_clouds(clouds[:1], session.layout)
    st2 = SparseTensor.from_point_clouds(clouds, session.layout)
    log(f"[inputs] 2 outdoor scenes {sizes} voxels, layout {session.layout}, "
        f"buckets {bucket_capacity(sizes[0])}/{bucket_capacity(sum(sizes))}, "
        f"{len(net.specs)} layers, made in {time.perf_counter() - t0:.1f} s")

    # -- 3. kernels vs plain, at the main path's shapes --------------------
    with Recorder() as rec:
        session(st2)
    torch.cuda.synchronize()
    results = {}

    # superwindow search: maps and overflow counters equal
    z = rec.calls["zdelta_superwindow_search"]
    err = 0
    t_k = t_p = b_tot = 0.0
    for i, (a, kw) in enumerate(z):
        mk, ok = zdelta_superwindow_cuda(*a, **kw)
        mp, op = zdelta_superwindow_torch(*a, **kw)
        if not (torch.equal(mk, mp) and torch.equal(ok, op)):
            raise RuntimeError(f"superwindow launch {i}: map or counters "
                               "differ from the plain version")
        err = max(err, int((mk - mp).abs().max()), int((ok - op).abs().max()))
        t_k += cuda_ms(lambda: zdelta_superwindow_cuda(*a, **kw), 3)
        t_p += cuda_ms(lambda: zdelta_superwindow_torch(*a, **kw), 2)
        arr, out2d, anchors, starts = a[:4]
        nb = 4 * (arr.numel() + out2d.numel() + anchors.numel()
                  + starts.numel() + mk.numel() + ok.numel())
        b_tot += bound_ms(nb, 0)[0]
    fine, coarse = z[0], z[[s.m_out for s in net.specs].index(4)]
    for label, (a, kw) in (("fine L0", fine), ("coarse L4", coarse)):
        log(f"[3 superwindow {label}] M={a[1].numel()} N={a[0].numel()} "
            f"G={a[2].numel()} SW={kw['SW']}: maps+counters equal, kernel "
            f"{cuda_ms(lambda: zdelta_superwindow_cuda(*a, **kw), 10):.4f} ms, "
            f"plain {cuda_ms(lambda: zdelta_superwindow_torch(*a, **kw), 3):.4f} ms")
    results["zdelta_superwindow_search"] = dict(
        max_abs_err=float(err), ms=t_k, plain_ms=t_p, bound_ms=b_tot,
        bound_by="bytes", library_ms=None)
    log(f"[3 superwindow] {len(z)} launches equal; per forward kernel "
        f"{t_k:.3f} ms, plain {t_p:.3f} ms, bound {b_tot:.4f} ms")

    # OS implicit GEMM: fp32 within 1e-5 * max(1, max|ref|)
    o = rec.calls["spconv_gather_gemm"]
    err = 0.0
    t_k = t_p = b_tot = ops_tot = bytes_tot = 0.0
    for i, (a, kw) in enumerate(o):
        F, m, W = a
        ok_ = spconv_gather_gemm(F, m, W)
        ref = spconv_gather_gemm_torch(F, m, W)
        d = float((ok_ - ref).abs().max())
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        if not d <= tol:
            raise RuntimeError(f"OS launch {i} ({F.shape[1]}->{W.shape[2]}): "
                               f"max|diff| {d} > {tol}")
        err = max(err, d)
        t_k += cuda_ms(lambda: spconv_gather_gemm(F, m, W), 3)
        t_p += cuda_ms(lambda: spconv_gather_gemm_torch(F, m, W), 2)
        nnz = int((m >= 0).sum())
        ops = 2.0 * nnz * F.shape[1] * W.shape[2]
        nb = 4 * (F.numel() + m.numel() + W.numel() + ok_.numel())
        b_tot += bound_ms(nb, ops)[0]
        ops_tot += ops
        bytes_tot += nb
    results["spconv_gather_gemm"] = dict(
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_tot,
        bound_by=bound_ms(bytes_tot, ops_tot)[1], library_ms=None)
    log(f"[3 os] {len(o)} launches within 1e-5*max(1,|ref|) (max|diff| "
        f"{err:.3e}); per forward kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
        f"bound {b_tot:.3f} ms ({ops_tot / 1e9:.1f} GFLOP useful, "
        f"{ops_tot / (t_k * 1e-3) / 1e12:.2f} TFLOP/s)")
    names = [s.name for s in net.specs]
    for name in ("stem0", "enc3_a", "dec0_up"):
        F, m, W = o[names.index(name)][0]
        for dt, tol_rel in ((torch.float32, None), (torch.bfloat16, 2e-2)):
            Fd, Wd = F.to(dt), W.to(dt)
            ok_ = spconv_gather_gemm(Fd, m, Wd).float()
            ref = spconv_gather_gemm_torch(Fd, m, Wd).float()
            d = float((ok_ - ref).abs().max())
            scale = float(ref.abs().max())
            tol = (1e-5 * max(1.0, scale) if tol_rel is None
                   else tol_rel * max(scale, 1e-30))
            if not d <= tol:
                raise RuntimeError(f"OS {name} {dt}: max|diff| {d} > {tol}")
            ms = cuda_ms(lambda: spconv_gather_gemm(Fd, m, Wd), 10)
            pms = cuda_ms(lambda: spconv_gather_gemm_torch(Fd, m, Wd), 3)
            log(f"[3 os {name} {str(dt)[6:]}] M={m.shape[0]} N={F.shape[0]} "
                f"{F.shape[1]}->{W.shape[2]} nnz={int((m >= 0).sum())}: "
                f"max|diff| {d:.3e} (tol {tol:.1e}), kernel {ms:.4f} ms, "
                f"plain {pms:.4f} ms")

    # segment sums: bitwise
    s_calls = rec.calls["segment_sum"]
    lib_rel = f64_rel = 0.0
    t_k = t_p = t_l = b_tot = ops_tot = bytes_tot = 0.0
    for i, (a, kw) in enumerate(s_calls):
        x, sid, starts, counts = a
        got = segsum_mod.segment_sum_cuda(x, sid, starts, counts, **kw)
        ref = segment_sum_torch(x, sid, starts, counts, **kw)
        if not torch.equal(got, ref):
            raise RuntimeError(f"segment_sum launch {i}: not bitwise equal "
                               f"(max|diff| {float((got - ref).abs().max())})")
        t_k += cuda_ms(lambda: segsum_mod.segment_sum_cuda(x, sid, starts,
                                                           counts, **kw), 3)
        t_p += cuda_ms(lambda: segment_sum_torch(x, sid, starts, counts,
                                                 **kw), 2)
        rows = int(counts.sum())
        xs = x[:rows]
        lengths = counts.long()
        exact = torch.stack([x[int(s0):int(s0) + int(c)].double().sum(0)
                             for s0, c in zip(starts, counts)])
        floor = 1e-6 * float(exact.abs().max()) + 1e-30
        rel = float(((got.double() - exact).abs()
                     / exact.abs().clamp(min=floor)).max())
        if not rel <= 1e-3:
            raise RuntimeError(f"segment_sum launch {i}: {rel:.2e} relative "
                               "from the fp64 sum")
        f64_rel = max(f64_rel, rel)
        lib_out = torch.segment_reduce(xs, "sum", lengths=lengths)
        lib_rel = max(lib_rel, float(((lib_out.double() - exact).abs()
                                      / exact.abs().clamp(min=floor)).max()))
        t_l += cuda_ms(lambda: torch.segment_reduce(xs, "sum",
                                                    lengths=lengths), 3)
        nb = 4 * (rows * x.shape[1] + got.numel())
        ops = float(rows * x.shape[1])
        b_tot += bound_ms(nb, ops)[0]
        ops_tot += ops
        bytes_tot += nb
    results["segment_sum"] = dict(
        max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=b_tot,
        bound_by=bound_ms(bytes_tot, ops_tot)[1], library_ms=t_l)
    log(f"[3 segsum] {len(s_calls)} launches bitwise equal (max rel diff "
        f"to an fp64 sum {f64_rel:.2e}); per forward "
        f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms, torch.segment_reduce "
        f"{t_l:.3f} ms (max rel diff to fp64 {lib_rel:.2e}), bound "
        f"{b_tot:.4f} ms")
    del rec, z, o, s_calls
    torch.cuda.empty_cache()

    # -- 4. main path --------------------------------------------------------
    reset_launch_counts()
    answers = {}
    times = {}
    for label, st in (("scene0", st1), ("batch2", st2)):
        for rep in range(2):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, health = session.run_with_health(st)
            logits = out.features
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = launch_counts()
            grew = {k: after[k] - before[k] for k in after}
            if any(v != len(net.specs) for v in grew.values()):
                raise RuntimeError(f"{label}: launches per call {grew}, "
                                   f"expected {len(net.specs)} each")
            n = int(out.count)
            if tuple(logits.shape) != (health.bucket, net.n_classes):
                raise RuntimeError(f"{label}: logits {tuple(logits.shape)}")
            if not bool(torch.isfinite(logits[:n]).all()):
                raise RuntimeError(f"{label}: non-finite logits")
            times.setdefault(label, []).append(dt * 1e3)
            answers[label] = (out, health)
    counts = launch_counts()
    out1, h1 = answers["scene0"]
    outb, hb = answers["batch2"]
    n1 = int(out1.count)
    b0 = outb.unbatch()[0]
    if int(b0.count) != n1 or not torch.equal(b0.packed[:n1], out1.packed[:n1]):
        raise RuntimeError("batched scene-0 coordinates differ from single")
    if not torch.equal(b0.features[:n1], out1.features[:n1]):
        d = float((b0.features[:n1] - out1.features[:n1]).abs().max())
        raise RuntimeError(f"batched scene-0 logits not bitwise equal to the "
                           f"single-scene run (max|diff| {d})")
    if session.compile_count != 2:
        raise RuntimeError(f"compile_count {session.compile_count} != 2 "
                           "distinct buckets")
    ovf = hb.window_overflow_cells
    log(f"[4 main path] MinkUNet-42 full width, 4 requests: logits finite, "
        f"batched scene 0 == single bitwise ({n1} rows), compile_count "
        f"{session.compile_count} (buckets {h1.bucket}, {hb.bucket}), "
        f"launches {counts} ({len(net.specs)} per kernel per call)")
    log(f"[4 main path] steady-state ms per call: scene0 "
        f"{times['scene0'][1]:.1f} (first {times['scene0'][0]:.1f}), batch2 "
        f"{times['batch2'][1]:.1f} (first {times['batch2'][0]:.1f}) | {kind} | "
        f"{card} | peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"[4 overflow cells per layer] "
        + " ".join(f"{k}={v}" for k, v in ovf.items()))
    wall, dev_ms = profile_call(lambda: session(st2))
    busy = sum(dev_ms.values())
    if busy > 0:
        steady = times["batch2"][1]
        top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
        log(f"[4 profile] batch2 under torch.profiler: wall {wall:.1f} ms, "
            f"device busy {busy:.1f} ms = {busy / steady:.1%} of the "
            f"unprofiled {steady:.1f} ms call (idle share "
            f"{1 - busy / steady:.1%}) | {card}")
        log("[4 profile] device ms by kernel: "
            + "; ".join(f"{k} {v:.2f}" for k, v in top))
    else:
        log("[4 profile] device time not measured: the profiler saw no "
            "device events")

    # -- 5. plain path on the same card --------------------------------------
    net_plain = pc.minkunet42(in_channels=4, n_classes=20, backend="torch")
    plain = compile_network(net_plain, batch[0].layout, batch=2,
                            params=session.params, engine="zdelta",
                            segment_backend="torch")
    plan_k = session.plan(st2)
    plan_p = plain.plan(st2)
    for name in names:
        if not torch.equal(plan_k.kmaps[name].m, plan_p.kmaps[name].m):
            raise RuntimeError(f"kernel map of {name} differs between the "
                               "superwindow kernel and the torch search")
    del plan_k, plan_p
    torch.cuda.empty_cache()
    reset_launch_counts()
    outp = plain(st2)
    if any(launch_counts().values()):
        raise RuntimeError(f"plain path launched kernels: {launch_counts()}")
    nb = int(outb.count)
    ref = outp.features[:nb]
    d = float((outb.features[:nb] - ref).abs().max())
    scale = float(ref.abs().max())
    if not d <= 1e-3 * scale:
        raise RuntimeError(f"kernel path vs plain path: max|diff| {d} > "
                           f"1e-3 * {scale}")
    log(f"[5 plain path] 42 kernel maps equal; logits max|diff| {d:.3e} vs "
        f"1e-3 * max|logits| = {1e-3 * scale:.3e} ({d / scale:.2e} relative)")

    # -- result ----------------------------------------------------------------
    table = []
    for name, r in results.items():
        src, rep = REPLACES[name]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "launches": counts[name], **r})
    log(json.dumps({"kernels": table}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

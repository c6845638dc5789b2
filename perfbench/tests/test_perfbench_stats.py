"""The rate, percentile, spread and idle-share arithmetic on synthetic
records, and the per-layer readers on a synthetic trace."""
import math

import pytest

from perfbench.tests.helpers import BENCH
from perfbench.lib import breakdown, harness, stats, work
from perfbench.lib.trace import Trace, from_csrc, short_name


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read


def ctx(**kw):
    base = dict(kind="closed", setup_s=20.0, window_s=10.0, calls=100,
                attempted=100, scenes=200, latencies=[], counters={},
                trace=None, work={}, peak=work.PEAKS["H100"])
    base.update(kw)
    return harness.Ctx(**base)


def test_rate_over_the_whole_window():
    assert reader("scenes_per_s")(ctx(scenes=221)) == pytest.approx(22.1)
    assert reader("train_scenes_per_s")(ctx()) is None
    assert reader("train_scenes_per_s")(ctx(kind="train", scenes=72)) == \
        pytest.approx(7.2)


def test_nearest_rank_percentile():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(v[::-1], 50) == 50
    lat = [i / 1000 for i in range(1, 201)]     # 1..200 ms
    got = reader("latency_ms_p95")(ctx(kind="open", latencies=lat,
                                       attempted=200))
    assert got == pytest.approx(190.0)


def test_unanswered_requests_count_as_slowest():
    lat = [0.01] * 90
    r = reader("latency_ms_p95")
    assert r(ctx(kind="open", latencies=lat, attempted=94)) == \
        pytest.approx(10.0)
    assert r(ctx(kind="open", latencies=lat, attempted=100)) is None


def test_union_gaps_and_idle_share():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)]
    assert stats.union(iv) == [(0, 15), (20, 31), (40, 40)]
    assert stats.covered(iv) == 26
    assert stats.gaps(iv, 0, 50) == [(15, 20), (31, 40), (40, 50)]
    ops = [("k", 0, 10), ("k", 5, 15), ("k", 20, 30)]
    tr = Trace(ops, [], 0, 40)
    assert breakdown.busy_s(tr) == pytest.approx(25e-9)
    c = ctx(trace=tr, window_s=40e-9)
    assert reader("idle_share.infer")(c) == pytest.approx(100 * 15 / 40)
    assert reader("idle_share.train")(c) is None


def test_breakdown_names_idle_time_by_the_open_host_range():
    ops = [("void (anonymous namespace)::os_mma_kernel<float, 64>(float*)",
            10, 20), ("Memcpy HtoD (Pageable -> Device)", 40, 45)]
    ranges = [("bench/call", 0, 25), ("bench/answer", 26, 50)]
    b = breakdown.of(Trace(ops, ranges, 0, 60))
    assert b["device_ops"][0] == ["os_mma_kernel<float, 64>", 1e-08]
    idle = dict(b["idle_gaps"])
    assert idle["bench/call"] == pytest.approx(10e-9 + 0)     # 0-10
    assert idle["bench/answer"] == pytest.approx(20e-9)       # 20-40
    assert idle["between ranges"] == pytest.approx(15e-9)     # 45-60
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_kernel_families_by_name():
    os_k = "void (anonymous namespace)::os_mma_kernel<float, 64>(float const*)"
    torch_k = ("void at::native::vectorized_elementwise_kernel<4, "
               "at::native::FillFunctor<float>>(int, float)")
    assert from_csrc(os_k) and not from_csrc(torch_k)
    assert short_name(os_k) == "os_mma_kernel<float, 64>"
    tr = Trace([(os_k, 0, 4_000_000), (torch_k, 4_000_000, 10_000_000),
                ("Memset (Device)", 10_000_000, 11_000_000)], [], 0,
               20_000_000)
    c = ctx(trace=tr, calls=2)
    assert reader("torch_op_ms.infer")(c) == pytest.approx(3.5)
    assert reader("launches_per_step.train")(ctx(kind="train", trace=tr,
                                                 calls=2)) == 1.0
    assert reader("plan_ms.infer")(c) is None


def test_roofline_and_mfu_arithmetic():
    pk = {"flops": 100.0, "bytes": 10.0}
    terms = [{"ops": 200.0, "bytes": 10.0},     # 2 s by operations
             {"ops": 100.0, "bytes": 30.0}]     # 3 s by bytes
    assert work.bound_seconds(terms, pk) == pytest.approx(5.0)
    os_k = "void (anonymous namespace)::os_mma_kernel<float, 64>(float)"
    tr = Trace([(os_k, 0, 10 * 10 ** 9)], [], 0, 20 * 10 ** 9)
    c = ctx(trace=tr, work={"os": terms, "model": [{"ops": 500.0,
                                                    "bytes": 0.0}]},
            peak=pk, window_s=20.0)
    assert reader("os_roofline.infer")(c) == pytest.approx(50.0)
    assert reader("ws_roofline.infer")(c) is None
    assert reader("mfu.infer")(c) == pytest.approx(100 * 500 / 2000)
    assert reader("mfu.train")(c) is None
    assert work.peak("NVIDIA H100 80GB HBM3") == work.PEAKS["H100"]
    assert work.peak("cpu") is None
    assert reader("os_roofline.infer")(ctx(trace=tr, peak=None,
                                           work={"os": terms})) is None


def test_service_and_device_ms_online():
    c = ctx(kind="open", counters={"call_count": 4, "call_seconds": 0.08},
            calls=4, trace=Trace([("k", 0, 40_000_000)], [], 0, 10 ** 9))
    assert reader("service_ms.online")(c) == pytest.approx(20.0)
    assert reader("device_ms.online")(c) == pytest.approx(10.0)
    assert reader("service_ms.online")(ctx()) is None
    assert not math.isnan(reader("setup_s")(c))

"""The open loop on the CPU at a small size: a fixed arrival schedule, a
sound run correct and an altered answer caught; the inference control
fails the committed logit limit."""
import json

import numpy as np

from perfbench.lib import drivers, harness
from perfbench.tests.helpers import (BENCH, NARROW, few_objects,
                                     no_import_check, small_tree)

CELL = "resnl20-online-b1"


def test_arrivals_are_a_fixed_poisson_schedule():
    mix = {"rate": 50.0, "arrival_seed": 7, "preroll_s": 4.0}
    (pre, a), (_, b) = drivers.arrivals(mix, 20.0), drivers.arrivals(mix, 20.0)
    np.testing.assert_array_equal(a, b)
    # each span offers exactly the rate
    assert len(a) == 1000 and len(pre) == 200
    assert np.all(np.diff(a) > 0) and 0.0 <= a[0] and a[-1] < 20.0
    assert np.all(np.diff(pre) > 0) and -4.0 <= pre[0] and pre[-1] < 0.0
    # Poisson gaps: exponential, mean 1 / rate and as wide as their mean
    gaps = np.diff(a)
    assert abs(gaps.mean() * 50.0 - 1.0) < 0.1
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.1
    # the window does not depend on the pre-roll's length
    np.testing.assert_array_equal(
        drivers.arrivals({**mix, "preroll_s": 0.0}, 20.0)[1], a)
    assert len(drivers.arrivals(mix, 20.0, rate=10.0)[1]) == 200


def test_the_backlog_reads_requests_waiting_and_the_longest_wait():
    due = [0.0, 1.0, 2.0, 3.0, 4.0]
    began = [0.0, 1.5, 3.0, 4.5]          # the last request never began
    r = drivers.backlog(due, began, 4.0)
    # at 2.0 the third request waits; at 4.0 the fourth and fifth
    assert r == {"backlog_mid": 1, "backlog_end": 2, "max_wait_s": 1.5}


def small_run(tmp_path, monkeypatch):
    few_objects(monkeypatch)
    no_import_check(monkeypatch)
    man, bench = small_tree(tmp_path, widths=NARROW,
                            limits={"logit_gap": 1e-2},
                            mix_over={"pool": 2, "warmup_rounds": 1,
                                      "rate": 20.0, "preroll_s": 0.2,
                                      "sample": 2})
    return harness.run(CELL, 2 ** 31 + 13, 0.3, False, started=0.0,
                       device="cpu", manifest=man, bench=bench)


def test_a_sound_run_is_correct_and_an_altered_answer_is_not(tmp_path,
                                                             monkeypatch):
    r = small_run(tmp_path / "a", monkeypatch)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 6 and r["failed"] == 0
    assert {"backlog_mid", "backlog_end", "max_wait_s"} <= set(r["notes"])
    assert set(r["metrics"]) == {"latency_ms_p95", "setup_s"}
    import repro_torch.serve.session as session
    real = session.pointcloud_forward

    def altered(*a, **kw):
        out = real(*a, **kw).clone()
        out[0, 0] += 1.0
        return out
    monkeypatch.setattr(session, "pointcloud_forward", altered)
    assert not small_run(tmp_path / "b", monkeypatch)["correct"]


def test_the_tf32_control_fails_the_cells_limits(monkeypatch):
    from perfbench import control
    from perfbench.tests.test_perfbench_reference import small_cell
    for cell in (CELL, "unet42-outdoor-b2", "resnl20-outdoor-b2"):
        c = small_cell(cell, monkeypatch)
        got = control.infer_readings(c, 22, "cpu")["logit_gap"]
        lim = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
        assert got > lim["checks"]["logit_gap"], (cell, got)

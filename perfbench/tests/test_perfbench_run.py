"""Whole runs of the inference cells on the CPU at a small size, with the
look for a card skipped: a sound run is correct, and a run whose timed path
is broken underneath is not. Also the command's refusals."""
import subprocess
import sys

import pytest
import torch

from perfbench.lib import harness, system
from perfbench.tests.helpers import (NARROW, ROOT, few_objects,
                                     no_import_check, small_tree)

# the small scenes' own fp32 rounding; the cells' limits are set at size
SMALL_LIMITS = {"logit_gap": 1e-2}


def small_run(tmp_path, monkeypatch, name="unet42-outdoor-b2", seconds=0.01):
    few_objects(monkeypatch)
    no_import_check(monkeypatch)
    man, bench = small_tree(tmp_path, widths=NARROW, limits=SMALL_LIMITS,
                            mix_over={"pool": 2, "warmup_rounds": 1,
                                      "sample_within": 1})
    return harness.run(name, 2 ** 31 + 11, seconds, False, started=0.0,
                       device="cpu", manifest=man, bench=bench)


def test_a_sound_run_is_correct(tmp_path, monkeypatch):
    r = small_run(tmp_path, monkeypatch)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"scenes_per_s", "setup_s"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["coord_mismatch"]["value"] == 0


def test_an_answer_altered_where_it_is_produced_is_caught(tmp_path,
                                                         monkeypatch):
    import repro_torch.serve.session as session
    real = session.pointcloud_forward

    def altered(*a, **kw):
        out = real(*a, **kw).clone()
        out[0, 0] += 1.0
        return out
    monkeypatch.setattr(session, "pointcloud_forward", altered)
    r = small_run(tmp_path, monkeypatch)
    assert not r["correct"]
    assert r["checks"]["logit_gap"]["value"] > SMALL_LIMITS["logit_gap"]


def test_half_of_the_batch_left_out_is_caught(tmp_path, monkeypatch):
    real = system.pack

    def first_scene_only(sess, batch):
        return real(sess, type(batch)(batch.coords[:1], batch.feats[:1]))
    monkeypatch.setattr(system, "pack", first_scene_only)
    r = small_run(tmp_path, monkeypatch)
    assert not r["correct"]
    assert r["checks"]["coord_mismatch"]["value"] > 0


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "unet42-outdoor-b2", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_the_command_refuses_without_the_program(tmp_path):
    """A tree holding only the manifest and the benchmark's files has no
    program to measure."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "unet42-outdoor-b2", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_a_reader_that_loads_jax_after_the_window_refuses_the_run(
        tmp_path, monkeypatch):
    """The look for JAX runs last: a module loaded by a metric reader,
    after the window and the check, still refuses the run."""
    import sys
    stub = tmp_path / "stub"
    (stub / "flax").mkdir(parents=True)
    (stub / "flax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    monkeypatch.delitem(sys.modules, "flax", raising=False)
    few_objects(monkeypatch)
    man, bench = small_tree(tmp_path / "t", widths=NARROW,
                            limits=SMALL_LIMITS,
                            mix_over={"pool": 2, "warmup_rounds": 1,
                                      "sample_within": 1})
    reader = bench / "metrics" / "setup_s.py"
    reader.write_text("import flax  # noqa: F401\n" + reader.read_text())
    before = set(sys.modules)
    real = harness.forbidden_modules
    # only what this run loads: the test process may hold JAX already
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda: real(set(sys.modules) - before))
    with pytest.raises(SystemExit, match="flax"):
        harness.run("unet42-outdoor-b2", 2 ** 31 + 11, 0.01, False,
                    started=0.0, device="cpu", manifest=man, bench=bench)

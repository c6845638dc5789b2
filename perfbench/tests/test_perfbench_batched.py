"""The cells at a network's measured knee (``unet42-outdoor-b4``,
``resnl20-outdoor-b8``): the batch-8 mix needs int64 words and the batch-4
mix does not, the harness decodes the program's int64 words, whole runs at
a small size are correct on the CPU, a run whose timed path is broken
underneath is not, and the TF32 control fails the cells' committed
limits."""
import json

import pytest
import torch

from perfbench.lib import check, system
from perfbench.tests.helpers import BENCH
from perfbench.tests.test_perfbench_reference import small_cell
from perfbench.tests.test_perfbench_run import SMALL_LIMITS, small_run

MIX = json.loads((BENCH / "mixes" / "outdoor-b8.json").read_text())
MIX4 = json.loads((BENCH / "mixes" / "outdoor-b4.json").read_text())
CELLS = ["unet42-outdoor-b4", "resnl20-outdoor-b8"]


def test_the_mix_needs_int64_words():
    from repro_torch.core.packing import BitLayout
    bits = check.layout_bits(MIX["extent"], MIX["scenes_per_call"])
    assert bits == (3, 11, 11, 7) and sum(bits) == 32
    layout = BitLayout.for_extent(*MIX["extent"],
                                  batch=MIX["scenes_per_call"])
    assert (layout.bb, layout.bx, layout.by, layout.bz) == bits
    assert layout.dtype == torch.int64


def test_the_batch4_mix_keeps_int32_words():
    from repro_torch.core.packing import BitLayout
    bits = check.layout_bits(MIX4["extent"], MIX4["scenes_per_call"])
    assert bits == (2, 11, 11, 7)
    layout = BitLayout.for_extent(*MIX4["extent"],
                                  batch=MIX4["scenes_per_call"])
    assert layout.dtype == torch.int32


def test_the_harness_decodes_the_programs_int64_words():
    from repro_torch.core.packing import BitLayout, pack
    layout = BitLayout.for_extent(*MIX["extent"],
                                  batch=MIX["scenes_per_call"])
    hi = [(1 << b) - 1 for b in (layout.bx, layout.by, layout.bz)]
    xyz = torch.tensor([[0, 0, 0], hi, [hi[0], 0, hi[2]], [16, 1055, 71]])
    b = torch.tensor([0, 7, 5, 3])
    words = pack(xyz, layout, b)
    assert words.dtype == torch.int64
    got = check.decode(words, MIX["extent"], MIX["scenes_per_call"])
    assert torch.equal(got, torch.cat([b[:, None], xyz], 1))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_batched_run_is_correct(name, tmp_path, monkeypatch):
    r = small_run(tmp_path, monkeypatch, name=name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"scenes_per_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(name, tmp_path,
                                                         monkeypatch):
    import repro_torch.serve.session as session
    real = session.pointcloud_forward

    def altered(*a, **kw):
        out = real(*a, **kw).clone()
        out[0, 0] += 1.0
        return out
    monkeypatch.setattr(session, "pointcloud_forward", altered)
    r = small_run(tmp_path, monkeypatch, name=name)
    assert not r["correct"]
    assert r["checks"]["logit_gap"]["value"] > SMALL_LIMITS["logit_gap"]


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_batch_left_out_is_caught(name, tmp_path, monkeypatch):
    real = system.pack

    def half(sess, batch):
        n = len(batch.coords) // 2
        return real(sess, type(batch)(batch.coords[:n], batch.feats[:n]))
    monkeypatch.setattr(system, "pack", half)
    r = small_run(tmp_path, monkeypatch, name=name)
    assert not r["correct"]
    assert r["checks"]["coord_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_the_cells_limit(name, monkeypatch):
    from perfbench import control
    c = small_cell(name, monkeypatch)
    got = control.infer_readings(c, 23, "cpu")["logit_gap"]
    lim = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    assert got > lim["checks"]["logit_gap"], got

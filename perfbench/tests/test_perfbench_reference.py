"""The frozen reference against the program's CPU path at a tiny size:
the same kernel maps pair for pair, logits within the fp32 path's own
rounding, and one training step's loss and gradients alike."""
import json
import statistics

import numpy as np
import pytest
import torch

from perfbench.lib import harness, inputs, reference, system
from perfbench.tests.helpers import NARROW, ROOT, SMALL_EXTENT, few_objects

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def small_cell(name, monkeypatch, objects=1, **mix):
    few_objects(monkeypatch, objects)
    c = harness.cell(MAN, name)
    c.cfg.update(NARROW[c.cfg["name"]])
    c.layers = harness.load_module(
        (ROOT / [x["file"] for x in MAN["configs"]
                 if x["name"] == c.cfg["name"]][0]).with_suffix(".py")
    ).layers(c.cfg)
    c.mix.update({"extent": SMALL_EXTENT, "pool": 1, **mix})
    return c


@pytest.mark.parametrize("name", ["unet42-outdoor-b2", "resnl20-outdoor-b2"])
def test_maps_and_logits_match_the_program(name, monkeypatch):
    c = small_cell(name, monkeypatch)
    (batch,) = inputs.pool(5, c.mix, c.cfg)
    w = inputs.weights(c.layers, c.cfg, 5, "cpu")
    net = system.network(c.cfg, c.layers)
    sess = system.session(c.cfg, net, system.model(net, w), c.mix["extent"],
                          2, "cpu")
    st = system.pack(sess, batch)
    plan = sess.plan(st)
    ref_plan = reference.build_plan(batch.coords, c.layers, "cpu")
    for L in c.layers:
        m = plan.kmaps[L.name].m
        for k, (rows, src) in enumerate(reference.layer_cols(ref_plan, L)):
            i = torch.nonzero(m[:, k] >= 0).flatten()
            assert torch.equal(i, rows), (L.name, k)
            assert torch.equal(m[i, k].long(), src), (L.name, k)
    out, health = sess.run_with_health(st)
    assert health.ok
    n = int(out.count)
    f64 = reference.forward(
        ref_plan, c.layers,
        reference.input_rows(ref_plan, batch.feats, "cpu", torch.float64),
        {k: v.double() for k, v in w.items()})
    f32 = reference.forward(
        ref_plan, c.layers,
        reference.input_rows(ref_plan, batch.feats, "cpu", torch.float32), w)
    scale = float(f64.abs().max())
    prog = float((out.features[:n].double() - f64).abs().max()) / scale
    own = float((f32.double() - f64).abs().max()) / scale
    assert n == f64.shape[0]
    assert prog <= 10 * own + 1e-6, (prog, own)


def test_a_training_step_matches_the_program(monkeypatch):
    c = small_cell("unet42-train-outdoor-b2", monkeypatch)
    (batch,) = inputs.pool(6, c.mix, c.cfg)
    w = inputs.weights(c.layers, c.cfg, 6, "cpu")
    net = system.network(c.cfg, c.layers)
    sess = system.session(c.cfg, net, system.model(net, w), c.mix["extent"],
                          2, "cpu")
    tr = system.trainer(sess, c.mix["opt"])
    loss = tr.step(*system.pack_labeled(sess, batch))["loss"]
    got = {k: float(v.double().norm()) / (1 - c.mix["opt"]["b1"])
           for k, v in tr.opt_state.mu.items()}
    plan = reference.build_plan(batch.coords, c.layers, "cpu")
    lab = reference.input_rows(plan, batch.labels, "cpu", None).long()

    def ref(dtype):
        return reference.train_steps(
            [plan], [reference.input_rows(plan, batch.feats, "cpu", dtype)],
            [lab], c.layers, {k: v.to(dtype) for k, v in w.items()},
            reference.AdamW(**c.mix["opt"]))
    r64, r32 = ref(torch.float64), ref(torch.float32)
    assert abs(loss - r64["losses"][0]) <= 1e-5 * r64["losses"][0]
    g64 = {k: float(v.norm()) for k, v in r64["first_grad"].items()}
    g32 = {k: float(v.double().norm()) for k, v in r32["first_grad"].items()}
    med = statistics.median(g64.values())
    prog = max(abs(got[k] - g64[k]) / max(g64[k], med) for k in g64)
    own = max(abs(g32[k] - g64[k]) / max(g64[k], med) for k in g64)
    assert prog <= 10 * own + 1e-6, (prog, own)
    assert np.isfinite(loss)

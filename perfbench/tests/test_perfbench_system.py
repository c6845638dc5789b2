"""The harness's wiring of a configuration into the program: a config's
own ``kwargs`` reach its constructor, the layer-by-layer comparison holds
the program to the reference's bias, and a bias-free layer gets no bias
drawn and none handed to the program, whose logits still match the
reference's."""
import dataclasses

import pytest
import torch

from perfbench.lib import inputs, reference, system
from perfbench.lib.reference import Layer
from perfbench.tests.test_perfbench_reference import small_cell

TINY = {"name": "tiny", "network": "tiny_segnet", "in_channels": 4,
        "n_classes": 8, "engine": "zdelta", "tuner": None,
        "kwargs": {"in_channels": 4, "n_classes": 8, "width": 8,
                   "depth": 3}}


def tiny_layers(**over):
    """The reference of ``tiny_segnet(width=8, depth=3)``; ``over`` maps a
    layer's name to fields it changes."""
    out = [Layer("stem", 4, 8, 3, 0, 0), Layer("sub0", 8, 8, 3, 0, 0),
           Layer("sub1", 8, 8, 3, 0, 0)]
    return [dataclasses.replace(L, **over.get(L.name, {})) for L in out]


def test_a_configs_kwargs_reach_a_constructor_the_default_call_cannot():
    net = system.network(TINY, tiny_layers())
    assert net.name == "tiny_segnet"
    assert [s.name for s in net.specs] == ["stem", "sub0", "sub1"]
    with pytest.raises(RuntimeError, match="layer 3"):
        system.network(dict(TINY, kwargs=dict(TINY["kwargs"], depth=4)),
                       tiny_layers())


@pytest.mark.parametrize("name", ["unet42-outdoor-b2", "resnl20-outdoor-b2"])
def test_kwargs_stating_the_default_call_build_the_same_network(
        name, monkeypatch):
    c = small_cell(name, monkeypatch)
    kw = dict(in_channels=c.cfg["in_channels"], n_classes=c.cfg["n_classes"],
              width=c.cfg["width"], dataflow=c.cfg["dataflow"])
    if c.cfg["dataflow"] == "hybrid":
        kw["t"] = c.cfg["t"]
    assert system.network(dict(c.cfg, kwargs=kw), c.layers).specs == \
        system.network(c.cfg, c.layers).specs


def test_the_layer_check_holds_the_program_to_the_references_bias():
    with pytest.raises(RuntimeError, match="layer 1"):
        system.network(TINY, tiny_layers(sub0={"bias": False}))


def test_a_bias_free_layer_gets_no_bias_and_matches_the_reference(
        monkeypatch):
    c = small_cell("unet42-outdoor-b2", monkeypatch)
    layers = tiny_layers(sub0={"bias": False})
    net = system.network(TINY, tiny_layers())
    net = dataclasses.replace(net, specs=tuple(
        dataclasses.replace(s, bias=L.bias) for s, L in zip(net.specs,
                                                            layers)))
    w = inputs.weights(layers, TINY, 11, "cpu")
    assert "layers.sub0.bias" not in w and "layers.sub1.bias" in w
    params = system.model(net, w)
    assert params.layers["sub0"].bias is None
    assert params.layers["sub1"].bias is not None
    (batch,) = inputs.pool(11, c.mix, TINY)
    sess = system.session(TINY, net, params, c.mix["extent"], 2, "cpu")
    out, health = sess.run_with_health(system.pack(sess, batch))
    assert health.ok
    plan = reference.build_plan(batch.coords, layers, "cpu")
    f64 = reference.forward(
        plan, layers,
        reference.input_rows(plan, batch.feats, "cpu", torch.float64),
        {k: v.double() for k, v in w.items()})
    f32 = reference.forward(
        plan, layers,
        reference.input_rows(plan, batch.feats, "cpu", torch.float32), w)
    n = int(out.count)
    assert n == f64.shape[0]
    scale = float(f64.abs().max())
    prog = float((out.features[:n].double() - f64).abs().max()) / scale
    own = float((f32.double() - f64).abs().max()) / scale
    assert prog <= 10 * own + 1e-6, (prog, own)
    # with the bias handed over after all, the logits move off the reference
    wb = dict(w, **{"layers.sub0.bias": torch.full((8,), 0.5)})
    biased = system.model(system.network(TINY, tiny_layers()), wb)
    sess = system.session(TINY, system.network(TINY, tiny_layers()), biased,
                          c.mix["extent"], 2, "cpu")
    out, _ = sess.run_with_health(system.pack(sess, batch))
    assert float((out.features[:n].double() - f64).abs().max()) / scale \
        > 1e3 * (own + 1e-9)

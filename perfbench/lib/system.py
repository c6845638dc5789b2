"""The system under test: every call the benchmark makes into the port
(``repro_torch``). No other module of the benchmark imports the program,
and nothing here computes what the reference compares."""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core.packing import BitLayout
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.core.spconv import SpConv
from repro_torch.models.pointcloud import NETWORKS, PointCloudModel
from repro_torch.serve import compile_network
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.pointcloud import PointCloudTrainConfig, labeled_tensor

CALL_SPAN = "session/call"


def network(cfg: dict, layers: Sequence):
    """The program's network for a configuration, held to the reference
    architecture layer by layer. The constructor takes the configuration's
    own ``kwargs`` where it has them, else its channels, width and
    dataflow."""
    if "kwargs" in cfg:
        kw = cfg["kwargs"]
    else:
        kw = dict(in_channels=cfg["in_channels"],
                  n_classes=cfg["n_classes"], width=tuple(cfg["width"]),
                  dataflow=cfg["dataflow"])
        if cfg["dataflow"] == "hybrid":
            kw["t"] = cfg["t"]
    net = NETWORKS[cfg["network"]](**kw)
    got = [(s.name, s.cin, s.cout, s.K, s.m_in, s.m_out, s.dataflow, s.t,
            s.bias) for s in net.specs]
    want = [(L.name, L.cin, L.cout, L.K, L.m_in, L.m_out, L.dataflow, L.t,
             L.bias) for L in layers]
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got + [None] * 99,
                                                    want + [None] * 99))
                   if a != b)
        raise RuntimeError(f"{cfg['name']}: the program's layer {bad} is "
                           f"{got[bad:bad + 1]}, the reference's "
                           f"{want[bad:bad + 1]}")
    return net


def model(net, weights: Dict[str, torch.Tensor]) -> PointCloudModel:
    """The program's parameters, copied from the benchmark's weights (the
    program updates its copy in place when it trains); a layer whose
    reference has no bias gets none."""
    def bias(name):
        b = weights.get(f"layers.{name}.bias")
        return None if b is None else b.clone()
    mods = {s.name: SpConv(s, weights[f"layers.{s.name}.weight"].clone(),
                           bias(s.name))
            for s in net.specs}
    return PointCloudModel(net, mods, weights["head"].clone())


def session(cfg: dict, net, params: PointCloudModel, extent, batch: int,
            device):
    """A session as a user builds one: the layout for the extent, the
    configuration's engine and tuner, CUDA graphs on the card."""
    return compile_network(net, BitLayout.for_extent(*extent), params=params,
                           batch=batch, engine=cfg["engine"],
                           tuner=cfg["tuner"], device=device)


def pack(sess, batch) -> SparseTensor:
    """One call's input, packed on the host."""
    return SparseTensor.from_point_clouds(list(zip(batch.coords,
                                                   batch.feats)),
                                          sess.layout, device="cpu")


def pack_labeled(sess, batch):
    """One training batch and its row-aligned labels, on the host."""
    return labeled_tensor(list(zip(batch.coords, batch.feats, batch.labels)),
                          sess.layout, device="cpu")


def trainer(sess, opt: dict):
    return sess.compile_train(PointCloudTrainConfig(opt=AdamWConfig(**opt)))


def call_span(sess) -> tuple:
    """The session's own call span so far: (count, seconds)."""
    h = sess.metrics.histogram(CALL_SPAN)
    return h.count, h.sum

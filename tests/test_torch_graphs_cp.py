"""CenterPoint-Large against the JAX session for the port's CUDA graphs,
on the CPU: the session's plan+forward body makes no host read or copy and
gives the JAX session's logits (the MinkUNet-42 case and the helpers are in
``test_torch_graphs.py``), and ``compile_count`` equals the JAX session's
jitted executables over two buckets and one escalation.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.core import SparseTensor as JST
from repro.models import pointcloud as jpc
from repro.serve import compile_network as j_compile

from repro_torch.convert import params_from_jax
from repro_torch.core.kernel_map import l1_partition
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.models import pointcloud as tpc
from repro_torch.serve import compile_network

from test_torch_graphs import CPU, WIDTH, T, _clouds, _tl, \
    check_body_against_jax

torch.set_num_threads(1)


def test_session_body_makes_no_host_read():
    """CenterPoint-Large (hybrid, K = 5) on outdoor sweeps."""
    check_body_against_jax("centerpoint_large")



def _lossy_capacity(net, layout, clouds) -> int:
    """A ws_capacity that the batch of both clouds overflows and one
    doubling cures (the largest sparse column over two, rounded up)."""
    s = compile_network(net, layout, batch=2, min_bucket=128, device=CPU)
    plan = s.plan(SparseTensor.from_point_clouds(clouds, s.layout,
                                                 device=CPU))
    top = max(int(plan.kmaps[sp.name].column_counts()[
        T(l1_partition(sp.K, sp.offset_stride, sp.t)[1]).long()].max())
        for sp in net.specs)
    return (top + 1) // 2


def test_compile_count_equals_the_jax_session():
    """CenterPoint with a lossy ws_capacity: a small crop (one bucket),
    then the batch with no replan budget (another bucket; the drops are
    reported), then the batch again, which escalates once. The port counts
    as many keys as the JAX session compiled executables (three), with
    the same health on every call."""
    jl, clouds = _clouds("indoor", (28, 24, 16), 5)
    tnet = tpc.centerpoint_large(width=WIDTH)
    cap = _lossy_capacity(tnet, _tl(jl), clouds)
    tnet = dataclasses.replace(tnet, specs=tuple(
        dataclasses.replace(s, ws_capacity=cap) for s in tnet.specs))
    jnet = jpc.centerpoint_large(width=WIDTH)
    jnet = dataclasses.replace(jnet, specs=tuple(
        dataclasses.replace(s, ws_capacity=cap) for s in jnet.specs))
    jparams = jpc.init_pointcloud(jax.random.key(0), jnet)
    js = j_compile(jnet, jl, params=jparams, batch=2, min_bucket=128)
    ts = compile_network(tnet, _tl(jl),
                         params=params_from_jax(jax.tree.map(
                             np.asarray, jparams), tnet, device=CPU),
                         batch=2, min_bucket=128, device=CPU)
    (c0, f0), _ = clouds
    traffic = [([(c0[:100], f0[:100])], None), (clouds, 0), (clouds, None)]
    healths = []
    for batch, budget in traffic:
        _, jh = js.run_with_health(JST.from_point_clouds(batch, js.layout),
                                   max_replans=budget)
        _, th = ts.run_with_health(SparseTensor.from_point_clouds(
            batch, ts.layout, device=CPU), max_replans=budget)
        assert (th.bucket, th.escalation, th.ws_dropped_pairs) == (
            jh.bucket, jh.escalation, jh.ws_dropped_pairs)
        healths.append(th)
    assert healths[0].ok and healths[0].bucket != healths[1].bucket
    assert not healths[1].ok and healths[1].replans == 0
    assert healths[2].replans == 1 and healths[2].ok
    assert js.compile_count == ts.compile_count == 3

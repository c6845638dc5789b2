"""The port's segment engine against the JAX package, BITWISE: the plain
segment sum equals ``segment_sum_xla`` and ``segment_sum_pallas`` run in
interpret mode, bit for bit, and keeps the schedule's invariances
(alignment, zero extension). BN and the scene segmentation match too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segsum as jss
from repro.models import pointcloud as jpc
from repro.core import packing as jpk

from repro_torch.core import packing as tpk
from repro_torch.kernels import segsum as tss
from repro_torch.models import pointcloud as tpc


# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def _data(sizes, cap, C=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(cap, C)).astype(np.float32)
    x[::7] *= 1e4                    # a wide dynamic range: rounding matters
    x[3] = -0.0
    sid, starts, counts = jss.segments_from_sizes(sizes, cap)
    x[sid == len(sizes)] = 0
    return x, sid, starts, counts


SIZES = [[300], [1, 0, 130], [64, 64, 65], [257, 0, 0, 31], [700, 111]]


@pytest.mark.parametrize("sizes", SIZES, ids=str)
@pytest.mark.parametrize("q", [8, 64])
def test_segment_sum_bitwise_equals_xla(sizes, q):
    cap = 1024
    x, sid, starts, counts = _data(sizes, cap, seed=len(sizes) + q)
    ref = np.asarray(jss.segment_sum_xla(
        jnp.asarray(x), jnp.asarray(sid), jnp.asarray(starts),
        jnp.asarray(counts), num_segments=len(sizes), q=q))
    got = N(tss.segment_sum_torch(T(x), T(sid), T(starts), T(counts),
                                  num_segments=len(sizes), q=q))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("sizes", SIZES[:3], ids=str)
def test_segment_sum_bitwise_equals_pallas_interpret(sizes):
    cap = 512
    x, sid, starts, counts = _data(sizes[:1] if sum(sizes) > cap else sizes,
                                   cap, seed=3)
    S = len(starts)
    ref = np.asarray(jss.segment_sum_pallas(
        jnp.asarray(x), jnp.asarray(sid), jnp.asarray(starts),
        num_segments=S, q=64, interpret=True))
    got = N(tss.segment_sum(T(x), T(sid), T(starts), T(counts),
                            num_segments=S))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_segment_sum_alignment_and_zero_extension_invariant():
    """A segment's bits do not depend on its offset or on PAD rows."""
    rng = np.random.default_rng(8)
    seg = rng.normal(size=(333, 5)).astype(np.float32)
    lone = np.zeros((512, 5), np.float32)
    lone[:333] = seg
    a = tss.segment_sum(T(lone), *map(T, jss.segments_from_sizes([333], 512)),
                        num_segments=1)
    other = rng.normal(size=(101, 5)).astype(np.float32)
    both = np.zeros((2048, 5), np.float32)
    both[:101] = other
    both[101:434] = seg
    b = tss.segment_sum(T(both),
                        *map(T, jss.segments_from_sizes([101, 333], 2048)),
                        num_segments=2)
    assert torch.equal(a[0], b[1])


def test_segment_helpers_match():
    sizes = [40, 0, 77]
    x, sid, starts, counts = _data(sizes, 256, C=3, seed=4)
    for a, b in zip(tss.segments_from_sizes(sizes, 256),
                    jss.segments_from_sizes(sizes, 256)):
        np.testing.assert_array_equal(a, b)
    jm = jss.segment_moments(jnp.asarray(x), jnp.asarray(sid),
                             jnp.asarray(starts), jnp.asarray(counts),
                             num_segments=3,
                             spec=jss.SegmentSpec(backend="xla"))
    tm = tss.segment_moments(T(x), T(sid), T(starts), T(counts),
                             num_segments=3)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    v = np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        N(tss.segment_gather(T(v), T(sid), T(starts), T(counts),
                             num_segments=3)),
        np.asarray(jss.segment_gather(jnp.asarray(v), jnp.asarray(sid),
                                      jnp.asarray(starts),
                                      jnp.asarray(counts), num_segments=3)))
    with pytest.raises(ValueError):
        tss.segments_from_sizes([300], 256)


def test_segment_call_counter_and_cpu_kernel_guard():
    x, sid, starts, counts = _data([50], 128, seed=5)
    tss.reset_segment_calls()
    tss.segment_sum(T(x), T(sid), T(starts), T(counts), num_segments=1)
    tss.segment_moments(T(x), T(sid), T(starts), T(counts), num_segments=1)
    assert tss.segment_call_count() == 2
    with pytest.raises(ValueError):
        tss.segment_sum(T(x), T(sid), T(starts), T(counts), num_segments=1,
                        spec=tss.SegmentSpec(backend="cuda"))
    with pytest.raises(ValueError):
        tss.segment_sum_cuda(T(x), T(sid), T(starts), T(counts),
                             num_segments=1)


@pytest.mark.parametrize("S", [1, 2])
def test_relu_bn_matches(S):
    rng = np.random.default_rng(S)
    cap, C = 640, 8
    sizes = [200, 311][:S]
    sid, starts, counts = jss.segments_from_sizes(sizes, cap)
    x = rng.normal(size=(cap, C)).astype(np.float32)
    total = sum(sizes)
    if S == 1:
        ref = jpc._relu_bn(jnp.asarray(x), jnp.asarray(total))
        got = tpc._relu_bn(T(x), torch.tensor(total, dtype=torch.int32))
    else:
        seg_j = (jnp.asarray(sid), jnp.asarray(starts), jnp.asarray(counts), S)
        ref = jpc._relu_bn(jnp.asarray(x), jnp.asarray(total), seg_j)
        seg_t = (T(sid), T(starts), T(counts), S)
        got = tpc._relu_bn(T(x), torch.tensor(total), seg_t)
    np.testing.assert_allclose(N(got), np.asarray(ref), rtol=0, atol=1e-5)
    assert np.all(N(got)[total:] == 0)


def test_packed_segments_match():
    tl = tpk.BitLayout(bx=8, by=8, bz=6, bb=2)
    jl = jpk.BitLayout(bx=8, by=8, bz=6, bb=2)
    rng = np.random.default_rng(0)
    c = rng.integers(16, 200, size=(90, 3))
    b = np.sort(rng.choice([0, 1, 3], size=90))
    p = np.sort(N(tpk.pack(T(c), tl, T(b))))
    p = np.concatenate([p, np.full(38, np.iinfo(np.int32).max, np.int32)])
    for a, r in zip(tpc.packed_segments(T(p), torch.tensor(90), tl)[:3],
                    jpc.packed_segments(jnp.asarray(p), jnp.asarray(90), jl)[:3]):
        np.testing.assert_array_equal(N(a), np.asarray(r))

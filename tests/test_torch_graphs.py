"""What the port's CUDA graphs rest on, checked on the CPU against the JAX
package: the window searches' overflow repair (its plain version, the
kernel's contract) against the reference's ``lax.cond`` repair on int32 and
int64 words; the session's plan+forward body and the LM decode body making
no host read and no host copy (``Tensor.item`` / ``tolist`` / ``__bool__``
/ ``__int__`` / ``__index__`` and numpy through ``torch.as_tensor`` /
``tensor`` / ``from_numpy`` patched to raise) while giving the JAX
session's logits (MinkUNet-42 here, CenterPoint-Large and
``compile_count`` against the JAX session's executables in
``test_torch_graphs_cp.py``) and the JAX engine's greedy tokens.

The capture and replay plumbing runs here too, with ``FakeGraph`` in place
of ``torch.cuda.CUDAGraph``: the body run under the capture context is
recorded and its outputs overwritten with garbage (a capture computes
nothing), and a replay re-runs it into the same output tensors, as a real
replay rewrites the graph's own memory. Against that stand-in: results
never alias the graph's outputs, keys replay in any order bitwise as eager
calls, an escalating call replays two keys, and reassigning ``params``
drops every key. The real graphs are checked on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SparseTensor as JST
from repro.core import packing as jpk
from repro.core import voxel as jvx
from repro.core import zdelta as jzd
from repro.core.network_plan import _pallas_map
from repro.data import scenes as jscenes
from repro.models import pointcloud as jpc
from repro.models import transformer as jtf
from repro.models.common import dense_lm as jdense_lm
from repro.serve import Request as JRequest, ServeEngine as JServeEngine
from repro.serve import compile_network as j_compile

from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.core import packing as tpk
from repro_torch.core import voxel as tvx
from repro_torch.core import zdelta as tzd
from repro_torch.core.kernel_map import l1_partition
from repro_torch.core.network_plan import _kernel_map_search
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.models import pointcloud as tpc
from repro_torch.models.common import dense_lm
from repro_torch.serve import Request, ServeEngine, compile_network
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import session as session_mod

# The suite runs in several worker processes at once: one intra-op thread
# each keeps torch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

CPU = "cpu"


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def no_host_reads():
    """Every way the body could read a tensor on the host, or copy numpy
    to the device, raises inside the block."""
    def refuse(what):
        def f(*a, **kw):
            raise AssertionError(f"host read or copy in the body: {what}")
        return f

    saved = [(torch.Tensor, name, getattr(torch.Tensor, name))
             for name in ("item", "tolist", "__bool__", "__int__",
                          "__index__")]
    for cls, name, _ in saved:
        setattr(cls, name, refuse(f"Tensor.{name}"))
    for name in ("as_tensor", "tensor", "from_numpy"):
        orig = getattr(torch, name)
        saved.append((torch, name, orig))

        def guarded(x, *a, _orig=orig, _name=name, **kw):
            if isinstance(x, (np.ndarray, np.generic)):
                raise AssertionError(f"host copy in the body: torch.{_name} "
                                     "of numpy")
            return _orig(x, *a, **kw)
        setattr(torch, name, guarded)
    try:
        yield
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)


# ---------------------------------------------------------------------------
# 1. the overflow repair against the reference's lax.cond repair
# ---------------------------------------------------------------------------

def _levels(dtype: str):
    """Coordinate sets of levels 0 and 1 of two rooms, JAX and port, on
    int32 words (their own layout) or int64 words (a 32-bit layout). Call
    it under ``jax.enable_x64`` for int64."""
    batch = jscenes.scene_batch(seed=3, batch=2, kind="indoor",
                                extent=(28, 24, 16), overlap=0.5)
    if dtype == "int32":
        tl = tpk.BitLayout(**dataclasses.asdict(batch[0].layout.with_batch(2)))
    else:
        tl = tpk.BitLayout(bx=12, by=12, bz=7, bb=1,
                           guard=batch[0].layout.guard)
    p = np.concatenate([N(tpk.pack(T(sc.coords), tl,
                                   torch.full((len(sc.coords),), b)))
                        for b, sc in enumerate(batch)])
    p = p[np.random.default_rng(3).permutation(len(p))]
    words = np.full(8192, tvx.pad_value(tl.dtype), p.dtype)
    words[: len(p)] = p
    jl = jpk.BitLayout(**dataclasses.asdict(tl))
    jc = jvx.downsample_all(jvx.build_coord_set(jnp.asarray(words)), jl,
                            (0, 1))
    tc = tvx.downsample_all(tvx.build_coord_set(T(words)), tl, (0, 1))
    assert tc[0].packed.dtype == tl.dtype == getattr(torch, dtype)
    return jl, tl, jc, tc


SEARCHES = {"superwindow": (True, False), "superwindow_half": (True, True),
            "window": (False, False)}


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("search", list(SEARCHES))
@pytest.mark.parametrize("m_out", [0, 1])
def test_repair_plain_matches_reference(dtype, search, m_out):
    """W=256 overflows the fine level: the port's repaired map (the repair
    kernel's plain version, taken unconditionally) equals the reference's
    (Pallas search in interpret mode, ``lax.cond`` repair) exactly, and so
    does the count of repaired cells; both equal the exact search."""
    superwindow, half = SEARCHES[search]
    K = 3
    G = tzd.symmetry_anchor_count(K) if half else K * K
    with jax.enable_x64(dtype == "int64"):
        jl, tl, jc, tc = _levels(dtype)
        _, janch, jz = jzd.zdelta_offsets(K, 1, jl)
        jm, jn = _pallas_map(jc[0], jc[m_out], janch[:G], jz, K=K, W=256,
                             superwindow=superwindow)
        jm, jn = np.asarray(jm), int(jn)
    _, tanch, tz = tzd.zdelta_offsets(K, 1, tl, device=CPU)
    tm, tn = _kernel_map_search(tc[0], tc[m_out], tanch[:G], tz, K=K, W=256,
                                superwindow=superwindow)
    assert tm.dtype == tn.dtype == torch.int32
    np.testing.assert_array_equal(N(tm), jm)
    assert int(tn) == jn > 0
    assert torch.equal(tm, tzd.zdelta_search(tc[0], tc[m_out], tanch[:G],
                                             tz, K=K))


# ---------------------------------------------------------------------------
# 2. the session body: no host read, the JAX session's logits
# ---------------------------------------------------------------------------

def _clouds(kind, extent, channels, seed=7):
    batch = jscenes.scene_batch(seed=seed, batch=2, kind=kind, extent=extent,
                                overlap=0.5)
    rng = np.random.default_rng(1)
    clouds = [(sc.coords, rng.normal(size=(len(sc.coords), channels))
               .astype(np.float32)) for sc in batch]
    return batch[0].layout, clouds


def _tl(jl):
    return tpk.BitLayout(**dataclasses.asdict(jl))


WIDTH = (8, 8, 8, 8)
# net, scene kind and extent (CenterPoint's stride-8 level needs outdoor
# sweeps: tiny rooms amplify BN rounding past the gate), input channels
NETS = {"minkunet42": (lambda m: m.minkunet42(width=WIDTH), "indoor",
                       (48, 40, 24), 4),
        "centerpoint_large": (lambda m: m.centerpoint_large(width=WIDTH),
                              "outdoor", (96, 96, 16), 5)}


def check_body_against_jax(name):
    """After one call (which builds the device constants, as a capture's
    warm-up does), the body runs with every host read refused: its logits,
    words and count bitwise the eager call's, the logits within
    1e-3 * max|ref| of the JAX session's (the session tests' gate)."""
    make, kind, extent, channels = NETS[name]
    jl, clouds = _clouds(kind, extent, channels)
    jnet, tnet = make(jpc), make(tpc)
    jparams = jpc.init_pointcloud(jax.random.key(0), jnet)
    js = j_compile(jnet, jl, params=jparams, batch=2, min_bucket=128)
    jo = js(JST.from_point_clouds(clouds, js.layout))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tnet,
                             device=CPU)
    ts = compile_network(tnet, _tl(jl), params=params, batch=2,
                         min_bucket=128, device=CPU)
    st = SparseTensor.from_point_clouds(clouds, ts.layout, device=CPU)
    eager = ts(st)
    stp = st.pad_to(ts._bucket(st.capacity))
    with torch.no_grad(), no_host_reads():
        logits, packed, count, counters = ts._body(0, stp.packed,
                                                   stp.features)
    assert torch.equal(logits, eager.features)
    assert torch.equal(packed, eager.packed) and torch.equal(count,
                                                             eager.count)
    assert counters.dtype == torch.int64
    assert counters.shape == (len(tnet.specs),)      # no lossy layer
    n = int(jo.count)
    assert int(count) == n
    ref = np.asarray(jo.features)[:n]
    got = N(logits)[:n]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-3 * float(np.abs(ref).max()))


def test_session_body_makes_no_host_read():
    """MinkUNet-42 (CenterPoint-Large: ``test_torch_graphs_cp.py``)."""
    check_body_against_jax("minkunet42")


# ---------------------------------------------------------------------------
# 4-5. capture and replay plumbing against a stand-in graph
# ---------------------------------------------------------------------------

class FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU (module doc)."""

    capturing = None            # the graph whose capture context is open

    def __init__(self):
        self.run = None
        self.outputs = None
        self.replays = 0

    def pool(self):
        return ("fake pool", id(self))

    def replay(self):
        for out, new in zip(self.outputs, self.run()):
            out.copy_(new)
        self.replays += 1


def _record(run, outputs):
    """Inside a capture: bind ``run`` to the capturing graph and poison
    the outputs (a capture computes nothing)."""
    g = FakeGraph.capturing
    if g is not None:
        g.run, g.outputs = run, outputs
        for o in outputs:
            o.fill_(-7)
    return outputs


class _Stream:
    def __init__(self, *a):
        pass

    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _fake_capture(graph, pool=None, stream=None, capture_error_mode=None):
    assert capture_error_mode == "thread_local"
    FakeGraph.capturing = graph
    try:
        yield
    finally:
        FakeGraph.capturing = None


@pytest.fixture
def fake_graphs(monkeypatch):
    """CPU sessions and engines take their graph path with FakeGraph."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(session_mod.SpiraSession, "_graphs",
                        property(lambda self: self.cuda_graphs))
    body = session_mod.SpiraSession._body

    def recorded_body(self, esc, packed, feats):
        return _record(lambda: body(self, esc, packed, feats),
                       body(self, esc, packed, feats))
    monkeypatch.setattr(session_mod.SpiraSession, "_body", recorded_body)
    decode = engine_mod.ServeEngine._decode_body

    def recorded_decode(self):
        return _record(lambda: decode(self), decode(self))
    monkeypatch.setattr(engine_mod.ServeEngine, "_decode_body",
                        recorded_decode)


def _small_sessions(capacity=None):
    """A small WS network's session on the stand-in graphs and an eager one
    with the same weights, optionally lossy."""
    jl, clouds = _clouds("indoor", (28, 24, 16), 5)
    net = tpc.tiny_segnet(in_channels=5, width=8, dataflow="ws")
    if capacity is not None:
        net = dataclasses.replace(net, specs=tuple(
            dataclasses.replace(s, ws_capacity=capacity) for s in net.specs))
    g = compile_network(net, _tl(jl), batch=2, seed=2, min_bucket=128,
                        device=CPU)
    e = compile_network(net, _tl(jl), batch=2, params=g.params,
                        min_bucket=128, device=CPU, cuda_graphs=False)
    return g, e, clouds


def _same(a, b):
    return (torch.equal(a.features, b.features)
            and torch.equal(a.packed, b.packed)
            and torch.equal(a.count, b.count))


def test_graph_results_never_alias_and_replay_in_any_order(fake_graphs):
    """Call A (one scene), B (the batch), A again, B again, then B through
    an escalation: every result bitwise the eager session's, A's first
    result unchanged by the later replays, one graph per key."""
    g, e, clouds = _small_sessions()
    a = SparseTensor.from_point_clouds(clouds[:1], g.layout, device=CPU)
    b = SparseTensor.from_point_clouds(clouds, g.layout, device=CPU)
    assert g._bucket(a.capacity) != g._bucket(b.capacity)
    out_a = g(a)
    kept_a = out_a.features.clone()
    for st in (b, a, b):
        assert _same(g(st), e(st))
    assert torch.equal(out_a.features, kept_a) and _same(out_a, e(a))
    assert g.compile_count == e.compile_count == 2
    graphs = [k for k in g._keys.values()]
    assert [k.graph.replays for k in graphs] == [2, 2]
    assert g.metrics.counter("session_graph_captures").value == 2
    assert g.metrics.counter("session_graph_replays").value == 4
    cap = int(max(g.plan(b).kmaps[s.name].column_counts().max()
                  for s in g.net.specs))
    lossy, lossy_e, _ = _small_sessions(capacity=(cap + 1) // 2)
    lossy.params = g.params
    lossy_e.params = g.params
    out, health = lossy.run_with_health(b)
    ref, ref_h = lossy_e.run_with_health(b)
    assert health.replans == 1 and health.ok
    assert health == ref_h and _same(out, ref)
    lossless = e(b)
    n = int(lossless.count)
    assert torch.equal(out.features[:n], lossless.features[:n])
    assert lossy.compile_count == 2
    assert lossy.metrics.counter("session_graph_replays").value == 2


def test_reassigning_params_drops_the_keys(fake_graphs):
    """New parameter tensors drop every captured key (a graph reads the
    old ones' addresses); the next call captures again and serves the new
    weights bitwise as an eager session does. In-place updates keep the
    keys and serve the new values."""
    g, e, clouds = _small_sessions()
    st = SparseTensor.from_point_clouds(clouds, g.layout, device=CPU)
    g(st)
    assert g.compile_count == 1
    new = tpc.init_pointcloud(g.net, seed=5, device=CPU)
    g.params = new
    assert g.compile_count == 0 and g._pool is None
    e.params = new
    assert _same(g(st), e(st)) and g.compile_count == 1
    with torch.no_grad():
        for p in new.parameters():
            p.mul_(0.5)
    assert _same(g(st), e(st)) and g.compile_count == 1


def test_eager_session_counts_keys_and_drops_them_with_params():
    """On the CPU (always eager) a key is counted once it runs, and new
    parameters drop the count as on the card."""
    _, e, clouds = _small_sessions()
    st = SparseTensor.from_point_clouds(clouds, e.layout, device=CPU)
    e(st)
    e(st)
    assert e.compile_count == 1
    e.params = tpc.init_pointcloud(e.net, seed=5, device=CPU)
    assert e.compile_count == 0


# ---------------------------------------------------------------------------
# 6. the LM decode body
# ---------------------------------------------------------------------------

def _tiny(make):
    return make("tiny", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                vocab=128, dtype="float32")


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "fake_graph"])
def test_decode_body_gives_the_jax_engines_tokens(graph, request):
    """Every decode step runs the body over the static token and position
    buffers with every host read refused (and, on the stand-in graph,
    once captured then replayed): greedy tokens equal the JAX engine's,
    with more requests than slots."""
    if graph:
        request.getfixturevalue("fake_graphs")
    jc, tc = _tiny(jdense_lm), _tiny(dense_lm)
    jp = jtf.init_params(jc, jax.random.key(0))[0]
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jc.vocab, (n,)).astype(np.int32)
               for n in (7, 12, 3, 9)]
    jreqs = [JRequest(prompt=p, max_new=5) for p in prompts]
    JServeEngine(jc, jp, batch_slots=2, cache_len=64).run(list(jreqs))
    eng = ServeEngine(tc, tp, batch_slots=2, cache_len=64)
    eng.cuda_graphs = graph
    body = eng._decode_body

    def guarded():
        with no_host_reads():
            return body()
    eng._decode_body = guarded
    treqs = [Request(prompt=p, max_new=5) for p in prompts]
    eng.run(list(treqs))
    assert [t.out for t in treqs] == [j.out for j in jreqs]
    if graph:
        assert eng._graph.replays == 8       # 4 requests x 4 decode steps

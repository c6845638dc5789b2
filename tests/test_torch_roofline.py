"""The port's roofline machinery: ``launch/roofline.py`` (H100 constants,
ring bytes), ``launch/op_analysis.py`` (per-device operation counts from
the operations the program issues), ``launch/dryrun.py`` and
``launch/report.py``.

Gold checks:
  * the ring-bytes formulas equal the reference's on its cases and a grid;
  * the op counter's dot FLOPs of a tiny dense LM forward equal the
    reference's ``hlo_analysis.analyze_module`` dot FLOPs of the same jitted
    forward, exactly, but for the attention, which the port counts by the
    kernels' closed form over the causal mask's kept pairs (the
    reference's chunked attention multiplies every pair);
  * counted per device under DTensor: a product on a fake 16×16 mesh
    counts each rank's local product, not the global one;
  * a mini multi-pod dry run on a fake (2, 2, 2) group counts FLOPs and
    collectives;
  * a recurrence counted for one trip times its trip count equals the
    walked count.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_analysis import analyze_module
from repro.launch.roofline import _ring_bytes as ref_ring_bytes
from repro.models import transformer as jtf
from repro.models.common import dense_lm as jdense_lm
from repro_torch import configs as tconfigs
from repro_torch.kernels import opcount
from repro_torch.launch import op_analysis, report, roofline
from repro_torch.launch.roofline import _ring_bytes
from repro_torch.models import mamba, xlstm
from repro_torch.models import transformer as ttf
from repro_torch.models.common import dense_lm

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_ring_bytes_formulas():
    assert _ring_bytes("all-reduce", 100, 4) == pytest.approx(150.0)
    assert _ring_bytes("all-gather", 100, 4) == pytest.approx(75.0)
    assert _ring_bytes("reduce-scatter", 25, 4) == pytest.approx(75.0)
    assert _ring_bytes("collective-permute", 100, 4) == 100.0
    assert _ring_bytes("all-reduce", 100, 1) == 0.0
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "send"):
        for size in (1, 4096, 10**9):
            for g in (1, 2, 16, 256, 512):
                assert _ring_bytes(op, size, g) == ref_ring_bytes(op, size, g)


def test_h100_constants():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.PEAK_FLOPS_FP32 == 67e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    assert roofline.HBM_BYTES == 80 * 10**9
    assert roofline._DTYPE_BYTES[torch.bfloat16] == 2
    r = roofline.Roofline(flops=989e12, bytes_accessed=3.35e12 / 2,
                          collective_bytes=450e9 / 4, arg_bytes=0,
                          temp_bytes=0)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 0.5, 0.25)
    assert r.bottleneck == "compute" and r.fraction_of_roofline() == 1.0
    assert roofline.model_flops(3e9, 8192, True) == 6 * 3e9 * 8192
    assert roofline.model_flops(3e9, 10, False) == 2 * 3e9 * 10
    assert roofline.model_flops_share(0.5, 1e9, 1000, True) == \
        pytest.approx(6e12 / (0.5 * 989e12))


def test_causal_pairs():
    for sq, skv in ((1, 1), (5, 5), (3, 7), (130, 200), (64, 64), (1, 10)):
        want = sum(min(skv, r + skv - sq + 1) for r in range(sq))
        assert opcount.causal_pairs(sq, skv) == want


def test_op_counter_dot_flops_equal_the_reference_analyzer():
    """Tiny dense LM forward (2 layers, d_model 64, 4 heads, KV 2, seq 32,
    batch 2): the port's matmul FLOPs equal the reference's non-attention
    dot FLOPs exactly; the attention is the kernels' closed form."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
              vocab=256, dtype="float32")
    jc = jdense_lm("tiny", **kw)
    jp, _ = jtf.init_params(jc, jax.random.key(0))
    jb = {"tokens": jnp.zeros((2, 32), jnp.int32)}
    compiled = jax.jit(lambda p, b: jtf.forward(p, jc, b)).lower(
        jp, jb).compile()
    ref = analyze_module(compiled.as_text())
    ref_attn = sum(v for k, v in ref.dot_flops_by_label.items()
                   if k in ("bqhd,bkhd->bhqk", "bhqk,bkhd->bhqd"))
    assert ref_attn == 4 * 2 * 4 * 32 * 32 * 16 * 2   # every (q, k) pair

    tc = dense_lm("tiny", **kw)
    tp, _ = ttf.init_params(tc, 0, device="cpu")
    with torch.no_grad(), op_analysis.OpCounter() as c:
        ttf.forward(tp, tc, {"tokens": torch.zeros((2, 32),
                                                   dtype=torch.int32)})
    assert c.flops_by_op["mm"] == ref.flops - ref_attn
    pairs = opcount.causal_pairs(32, 32)
    assert c.flops_by_op["flash_attention"] == 4 * 2 * 4 * pairs * 16 * 2
    assert c.flops == c.flops_by_op["mm"] + c.flops_by_op["flash_attention"]
    assert c.bytes > 0 and c.peak_live_bytes > 0
    assert c.collective_bytes == 0 and not c.collectives


@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_trip_multiplied_count_equals_the_walked_count(block):
    """One trip of a recurrence's loop counted ``n`` times equals walking
    all ``n`` trips (16 tokens in chunks of 4)."""
    arch = ("jamba-1.5-large-398b" if block == "mamba" else "xlstm-350m")
    cfg = tconfigs.get_config(arch, smoke=True)
    params, _ = ttf.init_params(cfg, 0, device="cpu")
    kind = {"mamba": "mamba", "mlstm": "mlstm", "slstm": "slstm"}[block]
    for si, sb in enumerate(cfg.superblocks):
        for bi, (k, _) in enumerate(sb.blocks):
            if k == kind:
                p = {n: t[0] for n, t in params[f"sb{si}"][f"b{bi}"].items()}
                break
        else:
            continue
        break
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    fwd = {"mamba": lambda: mamba.mamba_fwd(p, cfg, x, chunk=4),
           "mlstm": lambda: xlstm.mlstm_fwd(p, cfg, x, chunk=4),
           "slstm": lambda: xlstm.slstm_fwd(p, cfg, x)}[block]
    counts = []
    for trips in (True, False):
        with torch.no_grad(), op_analysis.OpCounter(trips=trips) as c:
            fwd()
        counts.append((c.flops, c.bytes, dict(c.flops_by_op)))
    assert counts[0] == counts[1]
    assert counts[0][0] > 0


DRYRUN = r"""
import json
import torch
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import dense_lm
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

cfg = dense_lm("tiny", n_layers=2, d_model=64, n_heads=8, n_kv=4, d_ff=128,
               vocab=256, dtype="bfloat16")
rec = dryrun.lower_cell("tiny", "train_tiny", mesh="2x2x2", cfg=cfg,
                        shape=ShapeSpec("train_tiny", "train", 64, 8))
# a product on a fake 16x16 mesh counts each rank's local product
dryrun._group(256)
mesh = make_mesh((16, 16), ("data", "model"))
with torch.device("meta"):
    x = torch.empty(256, 4096, 4096, dtype=torch.bfloat16)
    w = torch.empty(4096, 14336, dtype=torch.bfloat16)
xd = distribute_tensor(x, mesh, [Shard(0), Replicate()], src_data_rank=None)
wd = distribute_tensor(w, mesh, [Shard(0), Shard(1)], src_data_rank=None)
with op_analysis.OpCounter() as c:
    xd @ wd
rec["product_flops"] = c.flops
rec["product_collectives"] = [(o.op, list(o.shape), o.group_size)
                              for o in c.collectives]
print(json.dumps(rec))
"""


@pytest.fixture(scope="module")
def mini_dryrun(tmp_path_factory):
    path = tmp_path_factory.mktemp("dry") / "dryrun_check.py"
    path.write_text(DRYRUN)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_mini_multipod_dryrun(mini_dryrun):
    """The dry-run machinery on a fake 8-rank (2, 2, 2) pod x data x model
    group: the real train step on ``meta``, per-device FLOPs, collectives
    and roofline terms."""
    res = mini_dryrun
    assert res["devices"] == 8 and res["mesh"] == "2x2x2"
    assert res["flops_per_device"] > 0
    assert res["n_collectives"] > 0, "expected collectives in the step"
    assert res["collective_bytes_per_device"] > 0
    assert res["bottleneck"] in ("compute", "memory", "collective")
    assert res["n_params"] == sum(
        t.numel() for t in _leaves(ttf.abstract_params(dense_lm(
            "tiny", n_layers=2, d_model=64, n_heads=8, n_kv=4, d_ff=128,
            vocab=256, dtype="bfloat16"))[0]))
    assert res["param_bytes_per_device"] < 2 * res["n_params"]


def test_counts_are_per_device(mini_dryrun):
    """bf16 [256, 4096, 4096] @ [4096, 14336] with the batch over 16 data
    ranks and the weight's columns over 16 model ranks: each rank's local
    product, 2 * 16 * 4096 * 4096 * 896 FLOPs (the global product would be
    256x that), after one all-gather of the weight's data shards."""
    assert mini_dryrun["product_flops"] == 2.0 * 16 * 4096 * 4096 * 896
    assert mini_dryrun["product_collectives"] == [
        ["all-gather", [4096, 896], 16]]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_report_renders_a_results_file(mini_dryrun, tmp_path, capsys):
    res = {"tiny|train_tiny|2x2x2": mini_dryrun,
           "yi-9b|train_4k|16x16": {"arch": "yi-9b", "shape": "train_4k",
                                    "mesh": "16x16", "error": "boom"}}
    path = tmp_path / "r.json"
    path.write_text(json.dumps(res))
    report.main(["--json", str(path)])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("| arch | shape | mesh |")
    assert lines[0].endswith("fits H100 80 GB (data sheet) |")
    assert any(ln.startswith("| tiny | train_tiny | 2x2x2 |") for ln in lines)
    assert "| yi-9b|train_4k|16x16 | ERROR: boom |" in out
    assert "peak=989 TF/s bf16, HBM=3.35 TB/s, NVLink=450 GB/s" in out


@pytest.mark.parametrize("dataflow", ["os", "ws"])
def test_sparse_conv_counted_by_its_closed_form(dataflow):
    """The OS and WS gather GEMMs count 2 · pairs · Cin · Cout (the WS
    pairs cut to the capacity per column), whichever implementation runs;
    what the plain version does inside is not counted."""
    from repro_torch.core import dataflow as df
    g = torch.Generator().manual_seed(0)
    M, Kd, cin, cout, cap = 40, 27, 8, 16, 5
    f = torch.randn((M, cin), generator=g)
    m = torch.randint(-1, M, (M, Kd), generator=g, dtype=torch.int32)
    w = torch.randn((Kd, cin, cout), generator=g)
    with torch.no_grad(), op_analysis.OpCounter() as c:
        if dataflow == "os":
            df._os_primal(f, m, w, False, "auto", 0, 0)
        else:
            df._ws_primal(f, m, w, cap, "auto", 0, 0)
    cols = (m >= 0).sum(0)
    if dataflow == "ws":
        cols = cols.clamp(max=cap)
    name = {"os": "spconv_gather_gemm", "ws": "ws_scatter_gemm"}[dataflow]
    assert c.flops == c.flops_by_op[name] == 2.0 * float(cols.sum()) \
        * cin * cout
    assert list(c.flops_by_op) == [name]

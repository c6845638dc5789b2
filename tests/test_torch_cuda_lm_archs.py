"""Card-only tests of the LM architectures the port added beyond the dense
four: MoE FFNs, Mamba, mLSTM and sLSTM blocks and embedding inputs. They
skip without a card; run them on one with ``pytest -m cuda
tests/test_torch_cuda_lm_archs.py`` (README). Imports no JAX.

The smoke configs' 16-wide heads become 64 wide (the flash kernel takes
64, 128 or 256). On the card: each arch's prefill through the kernel
against the plain path and against the CPU (within 1e-4, or the CPU
path's own movement under a 1e-6 weight perturbation where more); the
slot engine's decode graph against the eager step for every recurrent
block kind (tokens equal and every state leaf bitwise equal after every
step: the recurrent state is restored after the capture's warm-up); and
the MoE decode step, run under the sync debug mode "error" and captured
into a CUDA graph by hand, with no host sync.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import transformer as lm
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.cuda

ARCHS = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b",
         "xlstm-350m", "musicgen-medium", "pixtral-12b"]
RECURRENT = {"mamba": "jamba-1.5-large-398b", "mlstm+slstm": "xlstm-350m",
             "moe": "qwen3-moe-30b-a3b"}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cfg(arch, dtype="float32"):
    cfg = configs.get_config(arch, smoke=True)
    return dataclasses.replace(cfg, head_dim=64, dtype=dtype)


def _n_attn(cfg):
    return sum(sb.repeat for sb in cfg.superblocks
               for kind, _ in sb.blocks if kind == "attn")


def _batch(arch, cfg, S, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    n_img = configs.embed_prefix_len(arch, S)
    b = {}
    if cfg.embedding_inputs or n_img:
        n = S if cfg.embedding_inputs else n_img
        b["embeds"] = torch.randn((2, n, cfg.d_model), generator=g,
                                  device=device)
    if not cfg.embedding_inputs:
        b["tokens"] = torch.randint(0, cfg.vocab, (2, S - n_img),
                                    generator=g, device=device)
    return b


def _cpu(tree):
    return {k: _cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def _moved(tree, seed=9):
    """Every leaf perturbed by 1e-6 relative (chip_smoke 6c's
    calibration)."""
    g = torch.Generator().manual_seed(seed)
    return {k: _moved(v, seed) if isinstance(v, dict)
            else v * (1 + 1e-6 * torch.randn(v.shape, generator=g))
            for k, v in tree.items()}


def _rel(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_card_against_plain_path_and_cpu(dev, arch):
    """fp32 prefill of 70 positions: one flash launch per attention layer,
    logits and every state leaf within 1e-4 of the plain path on the card
    and of the CPU (TF32 is off; cuBLAS and the CPU sum in other orders),
    or, where more, within the CPU path's own movement under a 1e-6
    weight perturbation, the calibration of chip_smoke's gradient gate (6c):
    the sLSTM state is ill-conditioned at random init
    (``tests/test_torch_lm_archs_model.py`` shows it against JAX), and
    there the card's rounding, compounded over 70 sequential steps, moved
    the cell state by 1.3e-4 of its max while one 1e-7 perturbation moved
    the CPU's by less than 1e-4."""
    cfg = _cfg(arch)
    params = lm.init_params(cfg, 0, device=dev)[0]
    b = _batch(arch, cfg, 70, dev)
    reset_launch_counts()
    lk, sk = lm.prefill(params, cfg, b, 96)
    assert launch_counts()["flash_attention"] == _n_attn(cfg)
    lp, sp = lm.prefill(params, cfg, b, 96, backend="torch")
    lc, sc = lm.prefill(_cpu(params), cfg, _cpu(b), 96)
    lm_, sm = lm.prefill(_moved(_cpu(params)), cfg, _cpu(b), 96)

    def close(got, want, moved, what):
        tol = max(1e-4, _rel(moved, want))
        assert _rel(got, want) <= tol, (what, _rel(got, want), tol)

    for other, so in ((lp, sp), (lc, sc)):
        close(lk, other, lm_, "logits")
        for sk_, blocks in sk.items():
            for bk, leaves in blocks.items():
                for n, t in leaves.items():
                    close(t, so[sk_][bk][n], sm[sk_][bk][n],
                          f"{sk_}/{bk}/{n}")


def _leaves(state):
    return [t for blocks in state.values() for leaves in blocks.values()
            for t in leaves.values()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(RECURRENT))
def test_decode_graph_equals_eager_bitwise(dev, kind, dtype):
    """A graph engine and an eager one over the same weights, three
    requests on 2 slots (a slot recycled), stepped in turns: greedy tokens
    equal and every state leaf bitwise equal after every step."""
    cfg = _cfg(RECURRENT[kind], dtype)
    params = lm.init_params(cfg, 0, device=dev)[0]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (7, 70, 12)]
    engines = {g: ServeEngine(cfg, params, batch_slots=2, cache_len=128,
                              cuda_graphs=g) for g in (True, False)}
    reqs = {g: [Request(prompt=p, max_new=6) for p in prompts]
            for g in engines}
    pending = {g: list(reqs[g]) for g in engines}
    steps = 0
    while pending[True] or engines[True].active:
        for g, eng in engines.items():
            while pending[g] and eng.free:
                eng.submit(pending[g].pop(0))
            eng.step()
        steps += 1
        assert [r.out for r in reqs[True]] == [r.out for r in reqs[False]]
        for a, b in zip(_leaves(engines[True].state),
                        _leaves(engines[False].state)):
            assert torch.equal(a, b), steps
    assert not engines[False].active and steps >= 10
    assert engines[True]._graph is not None


def test_moe_decode_step_captures_without_a_host_sync(dev):
    """The MoE decode body (static capacity 8 at 4 slots) runs under the
    sync debug mode "error", and a CUDA graph captured from it by hand
    replays the eager step's logits bitwise."""
    cfg = _cfg("qwen3-moe-30b-a3b", "bfloat16")
    params = lm.init_params(cfg, 0, device=dev)[0]
    eng = ServeEngine(cfg, params, batch_slots=4, cache_len=64,
                      cuda_graphs=False)
    for n in (5, 9):
        eng.submit(Request(prompt=np.arange(n, dtype=np.int32), max_new=50))
    eng.step()                  # cuBLAS handles and workspaces made here
    state0 = [t.clone() for t in _leaves(eng.state)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            want, _ = eng._decode_body()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = want.clone()
    for t, s in zip(_leaves(eng.state), state0):
        t.copy_(s)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side), torch.no_grad():
        got, _ = eng._decode_body()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)

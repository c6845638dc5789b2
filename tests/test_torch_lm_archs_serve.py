"""The slot engine on the architectures the port added beyond the dense
four, against the JAX package's: greedy tokens equal to the JAX engine's
for qwen3-moe (MoE FFNs), jamba (Mamba, attention, MoE) and xlstm (mLSTM,
sLSTM) at their fp32 smoke configs with converted parameters; prompts of
at least ``mamba_conv - 1`` tokens (a shorter one leaves a short conv
window, which both engines refuse to merge). The decode body runs with
every host read refused, eagerly and on ``FakeGraph`` (the CPU stand-in
for a CUDA graph of ``tests/test_torch_graphs.py``, whose capture really
runs the body, as the warm-up before a real capture does): the graph
engine's tokens and every state leaf bitwise the eager engine's after
every step, which holds only because the recurrent state is restored
after the capture (without the restore the leaves differ: checked). The
launch CLI serves xlstm and refuses embedding-input archs with the JAX
launcher's message.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.serve import Request as JRequest, ServeEngine as JServeEngine

from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as ttf
from repro_torch.serve import Request, ServeEngine

from test_torch_graphs import fake_graphs, no_host_reads  # noqa: F401

torch.set_num_threads(1)

SERVED = ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b", "xlstm-350m"]
_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jc = jconfigs.get_config(arch, smoke=True)
        tc = tconfigs.get_config(arch, smoke=True)
        jp = jtf.init_params(jc, jax.random.key(0))[0]
        tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                device="cpu")
        _PARAMS[arch] = (jc, tc, jp, tp)
    return _PARAMS[arch]


def _prompts(vocab, lengths, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("arch", SERVED)
def test_greedy_tokens_equal_the_jax_engine(arch):
    """2 slots, a 64-token cache, four requests (slots recycled): the
    recycled slot's recurrent state is replaced by the new prefill's."""
    jc, tc, jp, tp = _params(arch)
    prompts = _prompts(jc.vocab, (7, 12, 4, 9))
    jreqs = [JRequest(prompt=p, max_new=5) for p in prompts]
    JServeEngine(jc, jp, batch_slots=2, cache_len=64).run(list(jreqs))
    treqs = [Request(prompt=p, max_new=5) for p in prompts]
    eng = ServeEngine(tc, tp, batch_slots=2, cache_len=64)
    eng.run(list(treqs))
    for j, t in zip(jreqs, treqs):
        assert t.done and t.out == j.out, (t.out, j.out)
    assert sorted(eng.free) == [0, 1] and not eng.active


def test_engine_refuses_a_prompt_shorter_than_the_conv_window():
    """jamba's ``mamba_conv`` is 4: a 2-token prompt's prefill leaves a
    1-row window, which does not fit the slot's 3 rows (the reference's
    merge fails too; its launcher draws 4-47 tokens)."""
    _, tc, _, tp = _params("jamba-1.5-large-398b")
    eng = ServeEngine(tc, tp, batch_slots=2, cache_len=64)
    with pytest.raises(ValueError, match="conv"):
        eng.submit(Request(prompt=np.array([3, 5], np.int32), max_new=2))


def test_engine_refuses_embedding_input_archs():
    cfg = tconfigs.get_config("musicgen-medium", smoke=True)
    params = ttf.init_params(cfg, 0, device="cpu")[0]
    with pytest.raises(ValueError, match="frontend driver"):
        ServeEngine(cfg, params, batch_slots=2, cache_len=16)


def test_launch_cli_serves_xlstm(capsys):
    launch_serve.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "xlstm-350m: 3 reqs, 12 tokens" in out and "on cpu" in out


@pytest.mark.parametrize("arch", ["musicgen-medium", "pixtral-12b"])
def test_launch_cli_refuses_embedding_input_archs(arch):
    cfg = tconfigs.get_config(arch, smoke=True)
    if not cfg.embedding_inputs:     # pixtral's prefix is a batch option
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--requests", "1", "--max-new", "2"])
        return
    with pytest.raises(SystemExit, match="need a frontend driver"):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def _leaves(state):
    return [t for blocks in state.values() for leaves in blocks.values()
            for t in leaves.values()]


def _graph_vs_eager(arch, steps=6):
    """An engine on the stand-in graph and an eager one over the same
    weights, 2 slots, two requests, stepped in turns with every host read
    refused in the body: (tokens equal after every step, every state leaf
    bitwise equal after every step)."""
    _, tc, _, tp = _params(arch)
    engines = {}
    for graph in (False, True):
        eng = ServeEngine(tc, tp, batch_slots=2, cache_len=64)
        eng.cuda_graphs = graph
        body = eng._decode_body

        def guarded(body=body):
            with no_host_reads():
                return body()
        eng._decode_body = guarded
        reqs = [Request(prompt=p, max_new=10 ** 6)
                for p in _prompts(tc.vocab, (7, 12))]
        for r in reqs:
            eng.submit(r)
        engines[graph] = (eng, reqs)
    tokens, leaves = [], []
    for _ in range(steps):
        for graph in (False, True):
            engines[graph][0].step()
        (e, er), (g, gr) = engines[False], engines[True]
        tokens.append([r.out for r in er] == [r.out for r in gr])
        leaves.append(all(torch.equal(a, b) for a, b in
                          zip(_leaves(e.state), _leaves(g.state))))
    assert engines[True][0]._graph.replays == steps
    return tokens, leaves


@pytest.mark.parametrize("arch", SERVED)
def test_graph_engine_equals_eager_bitwise(arch, fake_graphs):  # noqa: F811
    tokens, leaves = _graph_vs_eager(arch)
    assert all(tokens) and all(leaves)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m"])
def test_without_the_restore_the_warm_up_advances_the_state(
        arch, fake_graphs, monkeypatch):  # noqa: F811
    """The check above finds the bug it guards against: with nothing
    restored after the capture, the warm-up and the stand-in capture have
    advanced the recurrent state, and the leaves differ from the first
    step on."""
    monkeypatch.setattr(ttf, "recurrent_leaves", lambda cfg, state: [])
    _, leaves = _graph_vs_eager(arch, steps=2)
    assert not any(leaves)

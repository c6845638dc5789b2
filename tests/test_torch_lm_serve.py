"""The port's slot engine against the JAX package's: greedy tokens equal on
the same (converted) parameters, with 2 slots, a 64-token cache and
prompts of 7 and 12 tokens (as the JAX engine's own test), also when more
requests than slots recycle them. Sampling (``temperature > 0``) draws
from the engine's ``torch.Generator``: the same distribution as the
reference's ``jax.random.categorical``, not the same numbers, so it is
checked for reproducibility only. The launch CLI runs with ``--smoke
--device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import dense_lm as jdense_lm
from repro.models import transformer as jtf
from repro.serve import Request as JRequest, ServeEngine as JServeEngine

from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models.common import dense_lm
from repro_torch.models import transformer as ttf
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)


def tiny(make):
    return make("tiny", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                vocab=128, dtype="float32")


@pytest.fixture(scope="module")
def models():
    jc, tc = tiny(jdense_lm), tiny(dense_lm)
    jp = jtf.init_params(jc, jax.random.key(0))[0]
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _prompts(vocab, lengths, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("lengths,max_new", [((7, 12), 6),
                                             ((7, 12, 3, 9), 5)])
def test_greedy_tokens_equal_the_jax_engine(models, lengths, max_new):
    jc, tc, jp, tp = models
    prompts = _prompts(jc.vocab, lengths)
    jreqs = [JRequest(prompt=p, max_new=max_new) for p in prompts]
    JServeEngine(jc, jp, batch_slots=2, cache_len=64).run(list(jreqs))
    treqs = [Request(prompt=p, max_new=max_new) for p in prompts]
    eng = ServeEngine(tc, tp, batch_slots=2, cache_len=64)
    eng.run(list(treqs))
    for j, t in zip(jreqs, treqs):
        assert t.done and t.out == j.out, (t.out, j.out)
    assert sorted(eng.free) == [0, 1] and not eng.active


def test_greedy_tokens_equal_forward_argmax(models):
    """Every generated token is the argmax of the port's full forward over
    the prompt and the tokens before it."""
    _, tc, _, tp = models
    prompts = _prompts(tc.vocab, (7, 12))
    reqs = [Request(prompt=p, max_new=4) for p in prompts]
    ServeEngine(tc, tp, batch_slots=2, cache_len=64).run(list(reqs))
    for p, r in zip(prompts, reqs):
        toks = list(p)
        for want in r.out:
            full = ttf.forward(tp, tc, {"tokens": torch.tensor([toks])})
            assert int(full[0, -1].argmax()) == want
            toks.append(want)


def test_sampling_is_reproducible_from_the_seed(models):
    _, tc, _, tp = models
    prompts = _prompts(tc.vocab, (5, 8))

    def run(seed):
        reqs = [Request(prompt=p, max_new=8, temperature=0.8)
                for p in prompts]
        ServeEngine(tc, tp, batch_slots=2, cache_len=32, seed=seed).run(
            list(reqs))
        return [r.out for r in reqs]

    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    assert all(0 <= t < tc.vocab for out in a for t in out)


def test_launch_cli_smoke_on_cpu(capsys):
    launch_serve.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--cache-len", "64",
                       "--max-new", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("yi-9b: 3 reqs, 12 tokens,") and "on cpu" in line

"""The port's examples (``examples/torch_*.py``) on the CPU: each runs its
``main(["--smoke", "--device", "cpu"])`` to its ✓ lines, and two are held
against the JAX package on the same inputs:

- quickstart: the kernel map equal to the reference's, and the OS, WS and
  hybrid outputs within the example's own agreement tolerance (rtol 2e-4,
  atol 2e-5) of ``repro.core``'s on the same scene, with features and
  weights from ``numpy.random.default_rng``;
- serve_lm: the greedy requests' tokens equal to the JAX engine's on the
  reference example's parameters (``jax.random.key(0)``) converted by
  ``convert.lm_params_from_jax``, in the example's mixed greedy/sampled
  run (sampled requests draw other numbers: ``torch.Generator``).

The point-cloud inference and training examples, MinkUNet-42 and its
training loop in plain torch, run in ``tests/test_torch_examples_pc.py``
and ``tests/test_torch_examples_pc_train.py``, so that ``--dist loadfile``
spreads them.
"""
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import core as jcore
from repro.data import scenes as jscenes
from repro.models import transformer as jtf
from repro.models.common import dense_lm as jdense_lm
from repro.serve import Request as JRequest, ServeEngine as JServeEngine
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import scenes

ROOT = Path(__file__).resolve().parent.parent
SMOKE_THREADS = 3


def example(name: str) -> dict:
    return runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                          run_name="example")


def run_smoke(name: str, capsys, *extra) -> str:
    """The example's ``main`` with ``--smoke --device cpu``, on
    ``SMOKE_THREADS`` torch threads (the suite's other files set one per
    worker, which leaves cores idle; MinkUNet-42 in plain torch takes
    ~2 min on one); its output, checked for a ✓ line."""
    threads = torch.get_num_threads()
    torch.set_num_threads(SMOKE_THREADS)
    try:
        example(name)["main"](["--smoke", "--device", "cpu", *extra])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "✓" in out and "Traceback" not in out
    return out


def test_quickstart_smoke(capsys):
    out = run_smoke("torch_quickstart", capsys)
    assert "all dataflows agree" in out


def test_quickstart_matches_the_reference():
    ex = example("torch_quickstart")
    K, cin, cout = ex["K"], ex["CIN"], ex["COUT"]
    kmap = ex["kernel_map"](scenes.indoor_scene(seed=0, room=ex["ROOM"]),
                            "cpu")
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(kmap.m.shape[0], cin)).astype(np.float32)
    w = (rng.normal(size=(K ** 3, cin, cout)) * 0.05).astype(np.float32)
    got = ex["dataflows"](kmap, torch.from_numpy(feats), torch.from_numpy(w))

    jscene = jscenes.indoor_scene(seed=0, room=ex["ROOM"])
    coords = jcore.build_coord_set(jnp.asarray(jscenes.pack_scene(jscene)))
    _, anchors, zstep = jcore.zdelta_offsets(K, 1, jscene.layout)
    jm = jcore.zdelta_search(coords, coords, anchors, zstep, K=K)
    np.testing.assert_array_equal(kmap.m.numpy(), np.asarray(jm))
    jk = jcore.KernelMap(m=jm, out_count=coords.count,
                         in_count=coords.count)
    cap = got[3]
    assert cap == int(np.asarray(jk.column_counts()).max()) + 8
    want = (jcore.output_stationary(feats, jm, w),
            jcore.weight_stationary(feats, jm, w, capacity=cap),
            jcore.hybrid(feats, jk, w, K=K, stride=1, t=3, ws_capacity=cap))
    for name, g, r in zip(("os", "ws", "hybrid"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_serve_lm_smoke(capsys):
    out = run_smoke("torch_serve_lm", capsys)
    assert "6 requests on 4 slots -> 144 tokens" in out


def test_serve_lm_greedy_tokens_equal_the_jax_engine():
    ex = example("torch_serve_lm")
    jc, tc = ex["config"](jdense_lm), ex["config"]()
    jp = jtf.init_params(jc, jax.random.key(0))[0]
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    reqs, _ = ex["serve"](tc, tp)
    jreqs = ex["requests"](jc.vocab, make=JRequest)
    JServeEngine(jc, jp, batch_slots=4, cache_len=128).run(list(jreqs))
    greedy = [i for i, (_, t) in enumerate(ex["REQUESTS"]) if t == 0.0]
    assert len(greedy) == 4
    for i in greedy:
        assert reqs[i].done and reqs[i].out == jreqs[i].out, i
    assert all(len(r.out) == 24 for r in reqs + jreqs)


def test_train_lm_smoke(capsys, tmp_path):
    out = run_smoke("torch_train_lm", capsys, "--steps", "3",
                    "--ckpt-dir", str(tmp_path / "ck"))
    assert "steps [0, 2]" in out


def test_robust_train_smoke(capsys):
    out = run_smoke("torch_robust_train", capsys)
    assert out.count("✓") == 4

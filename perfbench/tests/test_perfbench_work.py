"""The closed-form counts against hand counts at a tiny size, and the
reference's kernel maps against a brute-force enumeration."""
import itertools

import numpy as np
import pytest
import torch

from perfbench.lib import reference, work
from perfbench.lib.reference import Layer


def brute_pairs(coords, L):
    """Per offset, the (output, input) pairs found by a dictionary."""
    S = len(coords)
    lv = {}
    for m in {L.m_in, L.m_out}:
        rows = sorted({(b, *(int(v) >> m << m for v in c))
                       for b in range(S) for c in coords[b]})
        lv[m] = rows
    index = {r: i for i, r in enumerate(lv[L.m_in])}
    out = []
    for d in reference.offsets(L.K, L.stride):
        d = -d if L.transposed else d
        out.append(sorted((i, index[q]) for i, r in enumerate(lv[L.m_out])
                          for q in [(r[0], r[1] + d[0], r[2] + d[1],
                                     r[3] + d[2])] if q in index))
    return out


@pytest.mark.parametrize("K,m_in,m_out", [(3, 0, 0), (3, 0, 1), (3, 1, 0),
                                          (5, 1, 1)])
def test_reference_maps_match_brute_force(K, m_in, m_out):
    maps_match_brute_force(K, m_in, m_out, False)


@pytest.mark.parametrize("K,m_in,m_out,transposed", [
    (1, 1, 1, False), (2, 0, 1, False), (2, 1, 2, False), (2, 1, 0, True),
    (2, 2, 1, True)])
def test_k1_k2_and_transposed_maps_match_brute_force(K, m_in, m_out,
                                                     transposed):
    maps_match_brute_force(K, m_in, m_out, transposed)


def maps_match_brute_force(K, m_in, m_out, transposed):
    rng = np.random.default_rng(K * 10 + m_in * 3 + m_out)
    coords = [np.unique(rng.integers(16, 28, (60, 3)), axis=0)
              for _ in range(2)]
    L = Layer("l", 4, 4, K, m_in, m_out, transposed=transposed)
    plan = reference.build_plan(coords, [L], "cpu")
    got = reference.layer_cols(plan, L)
    want = brute_pairs(coords, L)
    for (rows, src), w in zip(got, want):
        assert sorted(zip(rows.tolist(), src.tolist())) == w
    np.testing.assert_array_equal(reference.layer_pairs(plan, L),
                                  [len(w) for w in want])


def test_a_transposed_map_is_kept_apart_from_the_untransposed_one():
    rng = np.random.default_rng(5)
    coords = [np.unique(rng.integers(16, 28, (60, 3)), axis=0)]
    a = Layer("a", 4, 4, 2, 1, 0)
    b = Layer("b", 4, 4, 2, 1, 0, transposed=True)
    plan = reference.build_plan(coords, [a, b], "cpu")
    for L in (a, b):
        got = reference.layer_cols(plan, L)
        assert [sorted(zip(r.tolist(), s.tolist())) for r, s in got] == \
            brute_pairs(coords, L)
    assert reference.layer_pairs(plan, a).sum() != \
        reference.layer_pairs(plan, b).sum()


def test_call_work_by_hand():
    # layer a: OS, K=3 (27 columns), 3 pairs in column 0 and 2 in column 13
    a = Layer("a", 4, 8, 3, 0, 0)
    pa = np.zeros(27, np.int64)
    pa[0], pa[13] = 3, 2
    # layer b: hybrid at t=1 (only the centre offset is OS), K=3 stride 1
    b = Layer("b", 8, 6, 3, 0, 0, dataflow="hybrid", t=1)
    pb = np.ones(27, np.int64)
    rows = [(10, 10), (10, 10)]
    fam = work.call_work([a, b], [pa, pb], rows, n_classes=5)
    # a: 2*5*4*8 ops; bytes: in 10*4*4, W 27*4*8*4, map 10*27*4, out 10*8*4
    assert fam["os"][0] == {"ops": 320.0, "bytes": 160 + 3456 + 1080 + 320}
    # b OS half: 1 pair, 1 column; WS half: 26 pairs, 26 columns
    assert fam["os"][1] == {"ops": 96.0,
                            "bytes": 10 * 8 * 4 + 8 * 6 * 4 + 10 * 4
                            + 10 * 6 * 4}
    assert fam["ws"][0] == {"ops": 2.0 * 26 * 8 * 6,
                            "bytes": 10 * 8 * 4 + 26 * 8 * 6 * 4
                            + 10 * 26 * 4 + 10 * 6 * 4}
    assert fam["dw"] == []
    head = 2.0 * 10 * 6 * 5
    assert work.total_ops(fam["model"]) == 320 + 96 + 2496 + head


def test_train_work_adds_df_but_the_first_layers_and_dw_of_all():
    a = Layer("a", 4, 8, 3, 0, 0)
    b = Layer("b", 8, 8, 3, 0, 0)
    p = np.full(27, 2, np.int64)
    fam = work.call_work([a, b], [p, p], [(10, 10)] * 2, n_classes=3,
                         train=True)
    fwd_a, fwd_b = 2.0 * 54 * 4 * 8, 2.0 * 54 * 8 * 8
    assert [t["ops"] for t in fam["os"]] == [fwd_a, fwd_b, fwd_b]
    assert [t["ops"] for t in fam["dw"]] == [fwd_a, fwd_b, 2.0 * 10 * 8 * 3]
    assert work.total_ops(fam["model"]) == pytest.approx(
        fwd_a + 2 * fwd_b + fwd_a + fwd_b + 3 * 2.0 * 10 * 8 * 3)


def test_work_matches_the_reference_products():
    """The useful operations counted equal the multiply-adds the reference
    performs (2 per product term)."""
    rng = np.random.default_rng(0)
    coords = [np.unique(rng.integers(16, 40, (200, 3)), axis=0)]
    layers = [Layer("a", 3, 4, 3, 0, 0), Layer("b", 4, 5, 3, 0, 1)]
    plan = reference.build_plan(coords, layers, "cpu")
    pairs = [reference.layer_pairs(plan, L) for L in layers]
    rows = [(plan.levels[L.m_in].keys.numel(),
             plan.levels[L.m_out].keys.numel()) for L in layers]
    fam = work.call_work(layers, pairs, rows, n_classes=2)
    macs = sum(int(r.numel()) * L.cin * L.cout for L in layers
               for r, _ in reference.layer_cols(plan, L))
    assert work.total_ops(fam["model"]) == 2 * macs + 2 * rows[1][1] * 5 * 2
    assert all(t["ops"] > 0 and t["bytes"] > 0 for t in fam["os"])
    assert torch.equal(plan.levels[1].keys, torch.sort(plan.levels[1].keys)
                       .values)
    assert list(itertools.chain(*[[int(r.numel()) for r, _ in v] for v in
                                  plan.pairs.values()])) == \
        [int(x) for p in pairs for x in p]

"""The manifest against the benchmark's contract, and the data files it
names."""
import ast
import json
import re

import pytest

from perfbench.tests.helpers import BENCH, ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(MAN) == TOP
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    texts = ("why", "layer") + (("source",) if section == "configs" else ())
    for e in MAN[section]:
        for v in (e[k] for k in texts if k in e):
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v


def test_units_better_and_sources():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_moves_names_a_metric_each_listed_cell_reports():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"] if reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(reports(m, w["name"]) for m in MAN["per_layer"])


def test_roofline_and_mfu_names_are_shares():
    for m in MAN["per_layer"]:
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_configs_and_files_exist():
    cfgs = {c["name"]: c for c in MAN["configs"]}
    pairs = set()
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in cfgs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH / "mixes" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert (ROOT / c["file"]).with_suffix(".py").is_file()
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_no_module_imports_jax_the_jax_package_or_the_old_benchmarks():
    for p in BENCH.rglob("*.py"):
        if "tests" in p.relative_to(BENCH).parts:
            continue
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)
        # only the adapter calls into the program
        if p.name != "system.py":
            assert "repro_torch" not in tops, p


def test_the_run_check_compares_whole_top_level_names():
    from perfbench.lib import harness
    mods = ["repro_torch", "repro_torch.serve.session", "jaxonomy",
            "torch", "perfbench.lib.harness"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["repro.core", "jaxlib._x"]) \
        == ["jaxlib", "repro"]


def test_reference_architectures_match_the_programs_networks():
    from perfbench.lib import harness, system
    for w in MAN["workloads"]:
        c = harness.cell(MAN, w["name"])
        net = system.network(c.cfg, c.layers)
        assert len(net.specs) == c.cfg["layers"] == len(c.layers)

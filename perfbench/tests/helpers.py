"""Helpers of the benchmark's tests: a copy of the benchmark's tree
with small scenes and narrow widths, so a whole run fits a test."""
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SMALL_EXTENT = [72, 72, 16]


def small_tree(tmp: Path, *, widths=None, mix_over=None, limits=None):
    """A benchmark tree under ``tmp``: the real manifest, readers and
    architectures, with configurations narrowed to ``widths`` (per config
    name), mixes on small scenes and the given limits. Returns (manifest,
    bench dir)."""
    bench = tmp / "perfbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in man["configs"]:
        p = tmp / c["file"]
        cfg = json.loads(p.read_text())
        cfg.update((widths or {}).get(c["name"], {}))
        p.write_text(json.dumps(cfg))
    for p in (bench / "mixes").glob("*.json"):
        mix = json.loads(p.read_text())
        mix["extent"] = SMALL_EXTENT
        mix.update(mix_over or {})
        p.write_text(json.dumps(mix))
    for p in (bench / "limits").glob("*.json"):
        lim = json.loads(p.read_text())
        lim["checks"].update(limits or {})
        p.write_text(json.dumps(lim))
    return man, bench


# narrow widths, and the plain z-delta search, whose maps every engine
# equals, in place of the CPU stand-in of the search kernel
NARROW = {"repo-unet42": {"width": [8, 16, 16, 32], "engine": "zdelta"},
          "repo-resnl20": {"width": [8, 8, 8, 16], "engine": "zdelta"}}


def no_import_check(monkeypatch):
    """Skip the run's look for JAX among the loaded modules: the test
    process may hold the JAX package for other tests (the look itself is
    tested on its own)."""
    from perfbench.lib import harness
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def few_objects(monkeypatch, n: int = 0):
    """Outdoor scenes with ``n`` objects (the ground alone by default: a
    batch of two fits the smallest bucket), so a small extent stays
    small."""
    import functools

    from perfbench.lib import scenes
    monkeypatch.setitem(scenes.KINDS, "outdoor", functools.partial(
        scenes.outdoor_scene, n_objects=n))

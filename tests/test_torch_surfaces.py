"""The port's package surfaces, its mesh helpers' default device and its CI
script, on the CPU.

- Every public name of each subpackage of the JAX package has its
  counterpart in the port's, in two surfaces: the public names of
  ``dir()`` after a fresh interpreter imports every subpackage of both
  packages, and the subpackage's modules on disk. ``RENAMES`` is the one
  written table of renames and ``OMITTED`` of omissions; each rename's two
  sides exist.
- ``launch.mesh``'s helpers build on the card unless the caller asks for
  the CPU (read from their signatures: no cuda mesh is built here).
- ``scripts/ci_torch.sh`` names only test node ids whose file defines the
  test, and runs every ``examples/torch_*.py`` (parsed, not run).
"""
import importlib
import inspect
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SUBPACKAGES = ["", "core", "data", "models", "serve", "train", "ckpt", "obs",
               "kernels", "launch", "dist", "configs"]
# reference name -> the port's counterpart, in any subpackage (prefixes end
# in "*"): the plain dataflows are torch, not XLA; the Pallas segment sum
# and the Pallas plan engines are CUDA kernels; the HLO analysis counts the
# operations the program issues
RENAMES = {
    "os_xla": "os_torch",
    "ws_xla": "ws_torch",
    "segment_sum_pallas": "segment_sum_cuda",
    "segment_sum_xla": "segment_sum_torch",
    "zdelta_pallas*": "zdelta_cuda*",
    "hlo_analysis": "op_analysis",
}
# (subpackage, name): the jnp oracles; each port kernel module has its
# plain *_torch version instead
OMITTED = {("kernels", "ref")}

SURFACES = r"""
import importlib, json, pkgutil, sys
subs, out = json.loads(sys.argv[1]), {}
for root in ("repro", "repro_torch"):
    for s in subs:
        importlib.import_module(root + ("." + s if s else ""))
for root in ("repro", "repro_torch"):
    for s in subs:
        pkg = importlib.import_module(root + ("." + s if s else ""))
        out[root + ":" + s] = {
            "dir": sorted(n for n in dir(pkg) if not n.startswith("_")),
            "modules": sorted(m.name for m in pkgutil.iter_modules(
                pkg.__path__) if not m.name.startswith("_"))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def surfaces():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", SURFACES,
                           json.dumps(SUBPACKAGES)], env=env, check=True,
                          capture_output=True, text=True, timeout=300)
    return json.loads(done.stdout)


def counterpart(name: str) -> str:
    for ref, port in RENAMES.items():
        if ref.endswith("*") and name.startswith(ref[:-1]):
            return port[:-1] + name[len(ref) - 1:]
        if name == ref:
            return port
    return name


@pytest.mark.parametrize("surface", ["dir", "modules"])
@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_port_exports_every_reference_name(surfaces, sub, surface):
    ref = surfaces["repro:" + sub][surface]
    port = set(surfaces["repro_torch:" + sub][surface])
    missing = sorted(n for n in ref if (sub, n) not in OMITTED
                     and counterpart(n) not in port)
    assert not missing, f"repro_torch.{sub} ({surface}) lacks {missing}"


def test_rename_table_pairs_existing_names():
    """Each rename's reference side exists in the JAX package and its
    counterpart in the port."""
    from repro.core import network_plan as jplan
    from repro_torch.core import network_plan as tplan
    pairs = [("repro.core", "os_xla", "repro_torch.core", "os_torch"),
             ("repro.core", "ws_xla", "repro_torch.core", "ws_torch"),
             ("repro.kernels.segsum", "segment_sum_pallas",
              "repro_torch.kernels.segsum", "segment_sum_cuda"),
             ("repro.kernels.segsum", "segment_sum_xla",
              "repro_torch.kernels.segsum", "segment_sum_torch")]
    for jmod, jname, tmod, tname in pairs:
        assert RENAMES[jname] == tname
        assert callable(getattr(importlib.import_module(jmod), jname))
        assert callable(getattr(importlib.import_module(tmod), tname))
    for engine in ("zdelta_pallas", "zdelta_pallas_window"):
        assert f'"{engine}"' in inspect.getsource(jplan)
        assert counterpart(engine) in tplan.ENGINES
    assert (ROOT / "src/repro/launch/hlo_analysis.py").is_file()
    assert (ROOT / "src/repro_torch/launch/op_analysis.py").is_file()


@pytest.mark.parametrize("helper", ["make_mesh", "make_production_mesh",
                                    "make_host_mesh"])
def test_mesh_helpers_default_to_the_card(helper):
    from repro_torch.launch import mesh
    param = inspect.signature(getattr(mesh, helper)).parameters[
        "device_type"]
    assert param.default == "cuda"


def _ci_script() -> str:
    return (ROOT / "scripts" / "ci_torch.sh").read_text()


def test_ci_torch_names_only_existing_tests():
    ids = re.findall(r"(tests/\w+\.py)::(\w+)", _ci_script())
    assert len(ids) >= 30
    for path, name in ids:
        src = (ROOT / path).read_text()
        assert re.search(rf"^def {name}\(", src, re.M), f"{path}::{name}"


def test_ci_torch_runs_every_port_example():
    script = _ci_script()
    named = set(re.findall(r"\btorch_\w+\b", script))
    on_disk = {p.stem for p in (ROOT / "examples").glob("torch_*.py")}
    assert len(on_disk) == 9 and on_disk <= named
    assert script.rstrip().endswith('echo "ci_torch.sh: OK"')
    assert os.access(ROOT / "scripts" / "ci_torch.sh", os.X_OK)

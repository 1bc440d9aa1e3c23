"""The PyTorch port stands alone: importing every ``repro_torch`` module
pulls in neither ``jax`` nor anything of the reference package ``repro``,
and no port source (nor ``chip_smoke.py``) names either in an import.
The telemetry layer and the tiered store import with both blocked, and
importing ``repro_torch.obs`` loads not even ``torch`` until a span opens
its profiler range."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(n for n in sys.modules if n in ("jax", "repro")
             or n.startswith(("jax.", "repro.")))
assert not bad, bad
print(len(names))
"""


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


def test_importing_every_port_module_loads_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every subpackage was walked


_BLOCKED = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "repro") or name.startswith(("jax.", "repro.")):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import repro_torch.launch.mesh as m
import repro_torch.train.loop
mesh = m.make_hierarchical_mesh([[0, 1], [2, 3]], devices=["cpu"] * 4)
print(mesh.shape)
"""


def test_mesh_and_sharded_loop_import_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(2, 2)"


def test_port_sources_name_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


_OBS_AND_STORE = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "repro") or name.startswith(("jax.", "repro.")):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import repro_torch.obs
import repro_torch.obs.report
# the profiler bridge resolves on the first annotated span, not at import
assert "torch" not in sys.modules, "repro_torch.obs imported torch"
tele = repro_torch.obs.Telemetry(repro_torch.obs.TelemetryConfig())
with tele.span("s"):
    pass
assert "torch" in sys.modules
import repro_torch.core.feature_store
import repro_torch.train.pipeline
import repro_torch.serve.server
print(tele.span_count)
"""


def test_obs_and_store_import_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _OBS_AND_STORE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1"


_RESILIENCE = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "repro") or name.startswith(("jax.", "repro.")):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import repro_torch.train.checkpoint as ck
import repro_torch.train.resilience as rs
import repro_torch.core.planner as pl
plan = rs.FaultPlan([rs.FaultSpec("prefetch_build", step=1)])
print(ck.MANIFEST_VERSION, callable(pl.replan_on_topology_change),
      plan.summary())
"""


def test_checkpoint_and_resilience_import_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RESILIENCE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1 True {'injected_prefetch_build': 0}"

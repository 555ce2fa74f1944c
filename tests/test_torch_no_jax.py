"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the reference package, and a Tarema
engine run completes in a process where ``import jax`` fails."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
from repro_torch.core.monitor import TraceDB
from repro_torch.core.scheduler import make_scheduler
from repro_torch.workflow.cluster import cluster_555
from repro_torch.workflow.engine import Engine, EngineConfig
from repro_torch.workflow.nfcore import WORKFLOWS
specs, db = cluster_555(), TraceDB()
for run in range(2):
    sched = make_scheduler("tarema", specs, seed=run, device="cpu")
    eng = Engine(specs, sched, db, EngineConfig(seed=run))
    eng.submit(WORKFLOWS["viralrecon"](), run_id=run, seed=0)
    res = eng.run()
    assert len(res["assignments"]) == len(eng.all_tasks) > 0
assert sched.grouping["k"] == 3
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not loaded, loaded
print("ok")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)\b(?!_torch)"
    r"|from\s+(?:jax|repro)\b(?!_torch)\S*\s+import\b)", re.MULTILINE)


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): _FORBIDDEN.findall(f.read_text())
           for f in files}
    assert not {f: m for f, m in bad.items() if m}

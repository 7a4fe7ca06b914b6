"""What a run loads and where it stops: no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or the JAX package's ``repro`` (compared whole:
the port's ``repro_torch`` begins with it), and no result without a card."""
import subprocess
import sys

import pytest

from conftest import BENCH

ROOT = BENCH.parent
SCRIPT = f"""
import runpy, sys
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(ROOT / 'src')!r}]
run = runpy.run_path({str(BENCH / 'run.py')!r}, run_name="portbench_run")
from conftest import run_tiny, tiny_cell
out = run_tiny(tiny_cell("mixtral-8x7b-d8.offpeak"), seconds=1.0, trace=True)
assert out["correct"], out["checks"]
print("FORBIDDEN", run["forbidden_modules"]())
print("LOADED", "repro_torch" in sys.modules)
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = {"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout and "LOADED True" in out.stdout


def test_forbidden_names_are_compared_whole():
    import runpy

    ns = runpy.run_path(str(BENCH / "run.py"), run_name="portbench_run")
    assert "repro" in ns["FORBIDDEN"] and "repro_torch" not in ns["FORBIDDEN"]


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "internlm2-1.8b.adhoc", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""

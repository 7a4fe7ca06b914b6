"""On the card: the control (the reference computed in TF32, the precision
below the configuration's float32, put in the program's place) fails the
cell's limits where the program passes them, at the cell's own size and a
short window; and a checkout of the benchmark's files alone gives no
result. ``python -m pytest portbench/tests -m cuda``."""
import shutil
import subprocess
import sys
import time

import pytest

from conftest import BENCH, find_cell

ROOT = BENCH.parent


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["internlm2-1.8b.adhoc", "mixtral-8x7b-d8.offpeak"])
def test_control_fails_where_the_program_passes(card, cell):
    """At the cell's own size: cut in depth, the control moves too little
    (mixtral at one layer: its K/V p99 3.2e-4 against the limit 0.05)."""
    from harness.cell import run_cell

    out = run_cell(find_cell(cell), 424242, 6.0, False, card, time.monotonic(), control=True)
    assert out["correct"], out["checks"]
    lim = {k: v["limit"] for k, v in out["checks"].items()}
    ctl = out["control"]
    assert any(ctl[k] > lim[k] for k in ctl if k in lim), (ctl, lim)


@pytest.mark.cuda
def test_benchmark_files_alone_give_no_result(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("out"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "internlm2-1.8b.adhoc", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""

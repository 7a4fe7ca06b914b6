"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; each
is a data file of its own under ``portbench/``: ``configs/<config>.json``
(its ``file`` key), ``traffic/<traffic>.json`` and ``limits/<cell>.json``
(the correctness limits of that cell). A per-layer metric is read by
``metrics/<base>.py``'s ``read(run)``, where the base is its name up to the
first dot: ``mfu.adhoc`` and ``mfu.backlog`` are one reader's readings in
the cells each lists. Later cells and metrics add files and entries; no
file here changes for them.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"{what} {name!r}: a name is 1-64 of letters, digits, '_', '.', '-', "
                         f"starting with a letter, a digit or '_'")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise ValueError(f"unit {unit!r}: 1-16 of letters, digits, '_', '/', '%', '.', '-'")
    return unit


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: dict  # the correctness limits of this cell
    chips: int
    end_to_end: tuple  # the end-to-end metric entries this cell reports
    per_layer: tuple  # the per-layer metric entries this cell reports


def load_bench(path: Path = ROOT / "BENCHMARK.json") -> dict:
    bench = json.loads(Path(path).read_text())
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            check_name(entry["name"], section)
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            check_unit(m["unit"])
    return bench


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = bench if bench is not None else load_bench(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{check_name(w['traffic'], 'traffic')}.json")
                         .read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name))
    layer = tuple(m for m in bench["per_layer"] if _reports(m, name))
    return Cell(name=name, config=config, traffic=traffic, limits=limits, chips=w["chips"],
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str):
    """``metrics/<base>.py``'s ``read`` (the base: ``name`` up to its first
    dot): run record -> value or None."""
    base = check_name(name, "metric").split(".")[0]
    path = BENCH_DIR / "metrics" / f"{base}.py"
    if not path.exists():
        raise FileNotFoundError(f"per-layer metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

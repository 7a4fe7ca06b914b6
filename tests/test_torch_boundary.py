"""The port stands alone: no module of src/repro_torch, nor chip_smoke.py,
imports JAX or the JAX package (not even a module of it that is free of
JAX), none calls a library attention kernel or torch.compile in place of
its own kernels, and the entry points run on CUDA unless told otherwise."""
import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import ServeEngine
from repro_torch.models.params import init_tree
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import LM

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_the_scan_sees_every_module_of_the_port():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert {"src/repro_torch/models/transformer.py", "src/repro_torch/kernels/ops.py",
            "src/repro_torch/launch/serve.py", "chip_smoke.py"} <= names
    # relative imports resolve inside the port: none climbs above it
    for path in PORT_FILES[:-1]:
        depth = len(path.relative_to(REPO / "src" / "repro_torch").parts) - 1
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level <= depth + 1, (path, node.module)


@pytest.mark.parametrize("path", PORT_FILES[:-1], ids=lambda p: str(p.relative_to(REPO)))
def test_port_calls_no_library_attention_or_compile(path):
    names = {n.attr for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.Attribute)}
    assert not names & {"scaled_dot_product_attention", "compile", "flash_attn"}


@pytest.mark.parametrize("fn", [ServeEngine.__init__, LM.__init__, build_model,
                                params_from_jax, init_tree])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_serve_cli_defaults_to_cuda():
    tree = ast.parse((REPO / "src" / "repro_torch" / "launch" / "serve.py").read_text())
    defaults = {
        call.args[0].value: kw.value.value
        for call in ast.walk(tree) if isinstance(call, ast.Call)
        and getattr(call.func, "attr", "") == "add_argument"
        for kw in call.keywords if kw.arg == "default"
    }
    assert defaults["--device"] == "cuda"


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.decode_attention",
    "repro_torch.kernels.ref", "repro_torch.models.transformer", "repro_torch.launch.serve",
])
def test_each_module_imports_first_in_a_fresh_interpreter(module):
    """The kernel modules and the model import each other's packages: no
    import order may hit a half-initialized module."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", f"import {module}"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

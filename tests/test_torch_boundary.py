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
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.convert import params_from_jax
from repro_torch.data.batches import TokenStream, make_batch
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch.serve import ServeEngine
from repro_torch.launch.train import train
from repro_torch.models.params import init_tree
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import LM
from repro_torch.training.step import init_state

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
    assert {"src/repro_torch/models/transformer.py", "src/repro_torch/models/ssd.py",
            "src/repro_torch/kernels/ops.py", "src/repro_torch/kernels/ssd_scan.py",
            "src/repro_torch/launch/serve.py", "src/repro_torch/launch/train.py",
            "src/repro_torch/checkpoint/store.py", "src/repro_torch/training/step.py",
            "src/repro_torch/optim/adamw.py", "src/repro_torch/data/batches.py",
            "chip_smoke.py"} <= names
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
                                params_from_jax, init_tree, train, init_state,
                                TokenStream.__init__, make_batch, CheckpointStore.restore])
def test_entry_points_default_to_cuda(fn):
    params = inspect.signature(fn).parameters
    if "device" not in params:
        # init_state draws on its model's device, and LM's default is cuda
        assert "model" in params
        params = inspect.signature(LM.__init__).parameters
    assert params["device"].default == "cuda"


def _cli_defaults(cli):
    tree = ast.parse((REPO / "src" / "repro_torch" / "launch" / cli).read_text())
    return {
        call.args[0].value: kw.value.value
        for call in ast.walk(tree) if isinstance(call, ast.Call)
        and getattr(call.func, "attr", "") == "add_argument"
        for kw in call.keywords if kw.arg == "default" and isinstance(kw.value, ast.Constant)
    }


def test_serve_cli_defaults_to_cuda():
    assert _cli_defaults("serve.py")["--device"] == "cuda"


def test_train_cli_defaults_to_cuda():
    assert _cli_defaults("train.py")["--device"] == "cuda"


def _inputs(device, requires_grad):
    def t(*shape, dtype=torch.float32):
        x = torch.zeros(shape, dtype=dtype, device=device)
        return x.requires_grad_() if requires_grad and dtype.is_floating_point else x

    flash = (flash_attention, (t(1, 8, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)), {})
    decode = (decode_attention, (t(1, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16),
                                 t(1, 8, dtype=torch.int32), t(1, dtype=torch.int32)), {})
    ssd = (ssd_scan, (t(1, 8, 2, 16), t(1, 8, 2), t(2), t(1, 8, 2, 16), t(1, 8, 2, 16)),
           {"chunk": 8})
    return [flash, decode, ssd]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["flash", "decode", "ssd"])
def test_the_grad_guard_of_each_raw_wrapper_is_reached_only_on_cuda(which):
    """On the CPU a wrapper computes its differentiable plain version; on
    any other device than CUDA the device check refuses first (ValueError,
    not the guard's RuntimeError). The CUDA side of the guard is a cuda
    case in tests/test_torch_cuda.py."""
    fn, args, kw = _inputs("cpu", True)[which]
    out = fn(*args, **kw)
    out = out[0] if isinstance(out, tuple) else out
    assert out.requires_grad
    fn, args, kw = _inputs("meta", True)[which]
    with pytest.raises(ValueError):
        fn(*args, **kw)


class _FakeCudaTensor:
    device = torch.device("cuda")
    requires_grad = True


def test_the_grad_guard_refuses_cuda_inputs_that_require_grad_under_grad_mode():
    with pytest.raises(RuntimeError, match="requires grad"):
        _build.refuse_grad("k", torch.zeros(1), _FakeCudaTensor())
    with torch.no_grad():
        _build.refuse_grad("k", _FakeCudaTensor())
    _build.refuse_grad("k", torch.zeros(1, requires_grad=True))  # a CPU input: no guard


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.decode_attention",
    "repro_torch.kernels.ssd_scan", "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.models.ssd", "repro_torch.models.transformer", "repro_torch.launch.serve",
    "repro_torch.launch.train", "repro_torch.training.step", "repro_torch.optim.adamw",
    "repro_torch.data.batches", "repro_torch.checkpoint.store", "repro_torch.convert",
])
def test_each_module_imports_first_in_a_fresh_interpreter(module):
    """The kernel modules and the model import each other's packages: no
    import order may hit a half-initialized module."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", f"import {module}"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

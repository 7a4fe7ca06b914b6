"""The JAX package's side of the SPMD tests (tests/test_torch_spmd_*.py): the
inputs both packages read, and the reference's jitted cell programs on a
mesh of host devices in a subprocess, run beside the port's spawned ranks.

``write_train_inputs`` / ``write_serve_inputs`` draw each case's params with
the JAX package and its batch (tokens, and the patch or frame embeddings
where the arch has them) and decode cache with numpy, as .npz files in the
test's tmp directory. ``run`` starts ``REF_SCRIPT`` (``XLA_FLAGS`` forcing
as many host devices as the mesh has), runs the port's ranks meanwhile and
returns when both are done.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from _torch_dist_workers import SPMD_CELLS, run_ranks
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import programs as jax_programs
from repro.models.config import ShapeCell as JaxShapeCell
from repro.models.transformer import LM as JaxLM

REPO = Path(__file__).resolve().parents[1]

REF_SCRIPT = r"""
import os, sys, json, functools
cfg = json.loads(sys.argv[3])
n = 1
for d in cfg["mesh"]:
    n *= d
os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n} "
                           "--xla_cpu_multi_thread_eigen=false")
sys.path.insert(0, sys.argv[1])
tmp = sys.argv[2]
import importlib
import numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.configs import SHAPES
from repro.launch import programs
from repro.launch.mesh import mesh_axis_kwargs
from repro.models.config import ShapeCell
from repro.optim import adamw
from repro.training import step

for name, (kind, seq, batch) in cfg["cells"].items():
    SHAPES[name] = ShapeCell(name, kind, seq, batch)
step.make_train_step = functools.partial(step.make_train_step, compute_dtype=jnp.float32)

def nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out

def flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

names = ("pod", "data", "model")[-len(cfg["mesh"]):]
mesh = jax.make_mesh(tuple(cfg["mesh"]), names, **mesh_axis_kwargs(len(names)))
for i, (arch, variant) in enumerate(cfg["train"]):
    inp = np.load(f"{tmp}/train_in_{i}.npz")
    mod = importlib.import_module(f"repro.configs.{configs._MODULES[arch]}")
    reduced = mod.REDUCED
    mod.REDUCED = reduced.replace(**cfg["patches"].get(variant, {}))
    try:
        prog = programs.build_program(arch, "tiny_train", mesh, reduced=True, variant=variant)
    finally:
        mod.REDUCED = reduced
    params = nest({k[len("params/"):]: jnp.asarray(inp[k]) for k in inp.files
                   if k.startswith("params/")})
    state = {"params": params, "opt": adamw.init(params), "step": jnp.zeros((), jnp.int32)}
    batch = {k: jnp.asarray(inp[k]) for k in inp.files if not k.startswith("params/")}
    out = {"loss": [], "grad_norm": []}
    with mesh:
        fn = prog.jitted()
        for s in range(2):
            state, m = fn(jax.device_put(state, prog.in_shardings[0]), batch)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            if s == 0:
                out.update({f"m/{k}": v for k, v in flat(state["opt"]["m"]).items()})
    out.update({f"params/{k}": v for k, v in flat(state["params"]).items()})
    np.savez(f"{tmp}/train_ref_{i}.npz", **out)
from repro.models.transformer import LM
bf16_prefill = LM.prefill
for i, (arch, cell, variant) in enumerate(cfg["serve"]):
    inp = np.load(f"{tmp}/serve_in_{i}.npz")
    prog = programs.build_program(arch, cell, mesh, reduced=True, variant=variant)
    LM.prefill = (functools.partialmethod(bf16_prefill, dtype=jnp.float32)
                  if i in cfg["f32_prefill"] else bf16_prefill)
    params = nest({k[len("params/"):]: jnp.asarray(inp[k], jnp.bfloat16) for k in inp.files
                   if k.startswith("params/")})
    toks = jnp.asarray(inp["tokens"])
    with mesh:
        if prog.kind == "prefill":
            batch = {"tokens": toks, **{k: jnp.asarray(inp[k], jnp.bfloat16)
                                        for k in ("patch_embeds", "enc_embeds") if k in inp.files}}
            logits, _ = prog.jitted()(params, batch)
        else:
            spec = {"/".join(k.key for k in path): sd for path, sd in
                    jax.tree_util.tree_flatten_with_path(prog.in_specs[1])[0]}
            cache = nest({k[len("cache/"):]: jnp.asarray(inp[k], spec[k[len("cache/"):]].dtype)
                          for k in inp.files if k.startswith("cache/")})
            logits, _ = prog.jitted()(params, cache, toks)
    np.savez(f"{tmp}/serve_ref_{i}.npz", logits=np.asarray(logits, np.float32))
print("OK")
"""


def _embeds(rng, cfg, batch: int, seq: int) -> dict:
    """A batch's embedding leaves (float32 normals), where the arch has
    them: a vision frontend's patches, an encoder-decoder's frames."""
    out = {}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = rng.standard_normal((batch, cfg.frontend_tokens, cfg.d_model),
                                                  dtype=np.float32)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.standard_normal((batch, seq, cfg.d_model), dtype=np.float32)
    return out


def write_train_inputs(tmp: Path, cases: list, patches: dict) -> None:
    """``tmp/train_in_<i>.npz`` for each ``(arch, variant)``: float32 params
    drawn by the JAX package from key i, and a ``tiny_train`` batch (tokens
    and next-token targets of the text positions, and the embeddings)."""
    rng = np.random.default_rng(0)
    for i, (arch, variant) in enumerate(cases):
        model = JaxLM(jax_get_config(arch, reduced=True).replace(**patches.get(variant, {})))
        params = model.init(jax.random.PRNGKey(i), dtype=jnp.float32)
        flat = {"params/" + "/".join(k.key for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
        _, seq, batch = SPMD_CELLS["tiny_train"]
        cfg = model.cfg
        st = seq - cfg.frontend_tokens if cfg.frontend == "vision_patches" else seq
        toks = rng.integers(0, cfg.vocab_size, (batch, st + 1)).astype(np.int32)
        np.savez(tmp / f"train_in_{i}.npz", tokens=toks[:, :-1], targets=toks[:, 1:],
                 **_embeds(rng, cfg, batch, seq), **flat)


def filled_cache(spec, S, seed):
    """A decode cache after an S-token context, as numpy (float32 for the
    bf16 leaves): random K/V (int8 codes and scales with kv_int8), cross
    K/V and SSM/conv state, pos_ids 0..S-1 then -1, lengths S."""
    rng = np.random.default_rng(seed)

    def one(path, sd):
        name = path[-1].key
        if name == "lengths":
            return np.full(sd.shape, S, np.int32)
        if name == "pos_ids":
            ar = np.arange(sd.shape[-1], dtype=np.int32)
            return np.broadcast_to(np.where(ar < S, ar, -1), sd.shape).copy()
        if sd.dtype == jnp.int8:
            return rng.integers(-127, 128, sd.shape).astype(np.int8)
        if name in ("k_s", "v_s"):
            return (rng.random(sd.shape) * 0.02 + 0.005).astype(np.float32)
        return np.asarray(jnp.asarray(rng.standard_normal(sd.shape), sd.dtype), np.float32)

    return {"/".join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map_with_path(one, spec))[0]}


def write_serve_inputs(tmp: Path, cases: list) -> None:
    """``tmp/serve_in_<i>.npz`` for each ``(arch, cell, variant)``: bf16
    params drawn by the JAX package from key i (stored as float32), the
    tokens, a prefill's embeddings and a decode's cache after a context of
    the cell's length."""
    from _pytest.monkeypatch import MonkeyPatch

    with MonkeyPatch.context() as mp:
        for name, (kind, seq, batch) in SPMD_CELLS.items():
            mp.setitem(JAX_SHAPES, name, JaxShapeCell(name, kind, seq, batch))
        for i, (arch, cell, variant) in enumerate(cases):
            ref = jax_programs.build_program(arch, cell, jax.make_mesh((1, 1), ("data", "model")),
                                             reduced=True, variant=variant)
            params = ref.model.init(jax.random.PRNGKey(i), dtype=jnp.bfloat16)
            flat = {"params/" + "/".join(k.key for k in path): np.asarray(v, np.float32)
                    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
            rng = np.random.default_rng(i)
            _, seq, batch = SPMD_CELLS[cell]
            cfg = ref.cfg
            if ref.kind == "prefill":
                st = seq - cfg.frontend_tokens if cfg.frontend == "vision_patches" else seq
                toks = rng.integers(0, cfg.vocab_size, (batch, st)).astype(np.int32)
                flat.update(_embeds(rng, cfg, batch, seq))
            else:
                toks = rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
                flat.update({f"cache/{k}": v for k, v in
                             filled_cache(ref.in_specs[1], seq, seed=i).items()})
            np.savez(tmp / f"serve_in_{i}.npz", tokens=toks, **flat)


def run(tmp: Path, mesh: tuple, rank_fn, world: int, rank_args: tuple, *, train=(), serve=(),
        patches=None, f32_prefill=(), timeout: float = 500) -> None:
    """The reference's programs of ``train`` (``(arch, variant)``) and
    ``serve`` (``(arch, cell, variant)``; the prefills of the indices in
    ``f32_prefill`` compute in float32) on a ``mesh``-shaped mesh of host
    devices in a subprocess, writing ``tmp/train_ref_<i>.npz`` and
    ``tmp/serve_ref_<i>.npz``, while ``rank_fn(rank, world, *rank_args)``
    runs in ``world`` spawned ranks; raises if either fails."""
    cfg = {"mesh": list(mesh), "train": list(train), "serve": list(serve),
           "cells": SPMD_CELLS, "patches": patches or {}, "f32_prefill": list(f32_prefill)}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(REPO / "src"), str(tmp),
                             json.dumps(cfg)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(rank_fn, world, rank_args, timeout=timeout)
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "OK" in out, err[-4000:]

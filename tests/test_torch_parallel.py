"""The port's sharding layer (``repro_torch/parallel``, the axes trees,
``launch/programs.py``'s microbatch and depth rules, the int8 compression)
against the JAX package's, on the CPU.

Everything here is exact: the rule tables, every ``spec_for`` over every
arch's param and cache axes on fake meshes of the reference's test shapes,
the axes trees, ``default_microbatches`` and ``_scaled_cfg``, the sequence
of ``shard`` sites a prefill and a decode step pass through, and
``quantize_int8`` / ``ef_compress`` bit for bit on the same numpy inputs.
The hypothesis properties are the port's counterparts of
tests/test_properties.py's (the same bounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st

from repro.configs import ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.data import batches as jax_batches
from repro.launch import programs as jax_programs
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import layers as jax_layers
from repro.models import ssd as jax_ssd
from repro.models import transformer as jax_transformer
from repro.parallel import compress as jax_compress
from repro.parallel import sharding as jax_sharding
from repro.training import step as jax_step
from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import batches
from repro_torch.launch import programs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import layers, ssd, transformer
from repro_torch.models.transformer import LM
from repro_torch.parallel import compress, sharding
from repro_torch.training import step

torch.set_num_threads(1)

ALL_ARCHS = list(ARCHS) + ["paper-default"]
MESHES = [(("data", 16), ("model", 16)), (("pod", 2), ("data", 16), ("model", 16)),
          (("data", 4), ("model", 1)), (("data", 2), ("model", 2))]
KINDS = ("train", "prefill", "decode", "long")


class _FakeMesh:
    """Mesh stand-in with arbitrary axis sizes (spec_for reads only shape),
    as tests/test_parallel.py fakes one."""

    def __init__(self, *axes):
        self.shape = dict(axes)


def _tables(mod, multi_pod):
    """Every rules table of a package: TRAIN, SERVE, LONG, rules_for of each
    kind and each variant's rules_fn of each kind (with the pod axis when
    ``multi_pod``), by name."""
    base = {"TRAIN": mod[0].TRAIN_RULES, "SERVE": mod[0].SERVE_RULES, "LONG": mod[0].LONG_RULES}
    out = {k: (mod[0].with_pod_axis(v) if multi_pod else v) for k, v in base.items()}
    for kind in KINDS:
        out[f"rules_for/{kind}"] = mod[0].rules_for(kind, multi_pod=multi_pod)
        for name, var in mod[1].VARIANTS.items():
            if "rules_fn" in var:
                out[f"{name}/{kind}"] = var["rules_fn"](kind, multi_pod)
    return out


PORT, REF = (sharding, programs), (jax_sharding, jax_programs)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# --- rule tables ------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_rule_tables_equal_reference(multi_pod):
    ours, ref = _tables(PORT, multi_pod), _tables(REF, multi_pod)
    assert ours.keys() == ref.keys()
    for name in ours:
        assert ours[name] == ref[name], name


def test_variants_equal_reference():
    assert programs.VARIANTS.keys() == jax_programs.VARIANTS.keys()
    for name, var in programs.VARIANTS.items():
        ref = jax_programs.VARIANTS[name]
        assert var.keys() == ref.keys(), name
        assert {k: v for k, v in var.items() if k != "rules_fn"} == \
               {k: v for k, v in ref.items() if k != "rules_fn"}, name


# --- axes trees ---------------------------------------------------------------

def _models(arch, reduced, kv_quant=False):
    return (LM(get_config(arch, reduced=reduced), device="cpu", kv_quant=kv_quant),
            jax_transformer.LM(jax_get_config(arch, reduced=reduced), kv_quant=kv_quant))


def _cache_specs(ours, ref, reduced):
    B, S = (2, 16) if reduced else (128, 32768)
    enc = S if ours.cfg.is_encoder_decoder else None
    return (programs._meta(ours.cache_spec(B, S, enc_len=enc)),
            ref.cache_spec(B, S, enc_len=enc))


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_cache_axes_equal_reference(arch, reduced):
    for kv_quant in (False, True):
        ours, ref = _models(arch, reduced, kv_quant)
        assert ours.param_axes() == ref.param_axes()
        ospec, rspec = _cache_specs(ours, ref, reduced)
        assert ours.cache_axes(ospec) == ref.cache_axes(rspec)
    assert step.state_axes(ours) == jax_step.state_axes(ref)


def test_batch_axes_equal_reference():
    for kind in ("train", "prefill"):
        cfg = get_config("internvl2-76b", reduced=True)
        assert batches.batch_axes(cfg, kind) == jax_batches.batch_axes(cfg, kind)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_for_equals_reference_on_every_leaf(arch, reduced):
    """spec_for over every param and cache leaf (int8 and cross caches
    included), every rules table, every fake mesh."""
    leaves = []
    for kv_quant in (False, True):
        ours, ref = _models(arch, reduced, kv_quant)
        shapes = ours.param_shapes()
        leaves += [(tuple(shapes_leaf.shape), axes) for (_, axes), (_, shapes_leaf) in
                   zip(_leaves(ours.param_axes()), _leaves(shapes))]
        ospec, _ = _cache_specs(ours, ref, reduced)
        leaves += [(tuple(s.shape), axes) for (_, axes), (_, s) in
                   zip(_leaves(ours.cache_axes(ospec)), _leaves(ospec))]
    n = 0
    for axes in MESHES:
        mesh = _FakeMesh(*axes)
        multi_pod = axes[0][0] == "pod"
        ours_t, ref_t = _tables(PORT, multi_pod), _tables(REF, multi_pod)
        for name in ours_t:
            for shape, la in leaves:
                got = sharding.spec_for(shape, la, ours_t[name], mesh)
                want = jax_sharding.spec_for(shape, la, ref_t[name], mesh)
                assert tuple(got) == tuple(want), (name, axes, shape, la)
                n += 1
    assert n > 1000


# --- the cell programs' microbatch and depth rules ----------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_default_microbatches_and_scaled_cfg_equal_reference(arch):
    for reduced in (True, False):
        cfg, jcfg = get_config(arch, reduced=reduced), jax_get_config(arch, reduced=reduced)
        ours, ref = LM(cfg, device="cpu"), jax_transformer.LM(jcfg)
        for depth in (None, 1, 2):
            got = programs._scaled_cfg(cfg, depth, ours.period, ours.n_super)
            want = jax_programs._scaled_cfg(jcfg, depth, ref.period, ref.n_super)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), depth
        for cell in SHAPES.values():
            for axes in MESHES:
                mesh = _FakeMesh(*axes)
                mp = axes[0][0] == "pod"
                kind = "long" if cell.name == "long_500k" else cell.kind
                got = programs.default_microbatches(cfg, cell, mesh,
                                                    sharding.rules_for(kind, multi_pod=mp))
                want = jax_programs.default_microbatches(
                    jcfg, JAX_SHAPES[cell.name], mesh, jax_sharding.rules_for(kind, multi_pod=mp))
                assert got == want, (cell.name, axes)


# --- specs, shardings and shard -------------------------------------------------

def test_named_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _FakeMesh(("pod", 2), ("data", 16), ("model", 16))
    rules = sharding.with_pod_axis(sharding.TRAIN_RULES)
    spec = sharding.spec_for((256, 4096, 32), ("batch", "seq", "heads"), rules, mesh)
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert sharding.NamedSharding(mesh, spec).placements == (Shard(0), Shard(0), Shard(2))
    spec = sharding.P(None, "data")
    assert sharding.NamedSharding(mesh, spec).placements == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        sharding.NamedSharding(mesh, sharding.P(("data", "pod"))).placements


def test_shard_is_identity_off_mesh_and_on_one_device_and_raises_on_more():
    x = torch.zeros(4, 2)
    assert sharding.shard(x, "batch", "embed") is x
    with sharding.sharding_ctx(_FakeMesh(("data", 1), ("model", 1)), sharding.TRAIN_RULES):
        assert sharding.shard(x, "batch", "embed") is x
    with sharding.sharding_ctx(_FakeMesh(("data", 2), ("model", 1)), sharding.TRAIN_RULES):
        with pytest.raises(TypeError, match="plain tensor"):  # a larger mesh takes DTensors
            sharding.shard(x, "batch", "embed")
    assert sharding._CTX.mesh is None  # the context is restored


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo world for the test, destroyed after it."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


SITE_ARCHS = ["qwen2-0.5b", "mixtral-8x7b", "mamba2-2.7b", "seamless-m4t-large-v2"]


def _record(monkeypatch, modules, log):
    for mod in modules:
        orig = mod.shard

        def rec(x, *axes, _orig=orig):
            log.append((tuple(x.shape), axes))
            return _orig(x, *axes)

        monkeypatch.setattr(mod, "shard", rec)


@pytest.mark.parametrize("arch", SITE_ARCHS)
def test_shard_sites_match_reference(arch, monkeypatch, world1):
    """One prefill and one decode step of a reduced config, cut to one
    super-layer (the reference's ``lax.scan`` traces its layer body once for
    every layer; with one layer the two packages' sequences are comparable
    as lists), pass the same (shape, logical axes) sites in the same order,
    each under a (1,1) mesh of its package and SERVE_RULES."""
    jcfg = jax_get_config(arch, reduced=True)
    probe = jax_transformer.LM(jcfg)
    kw = {"num_layers": probe.period}
    if jcfg.is_encoder_decoder:
        kw["num_encoder_layers"] = 1
    jcfg = jcfg.replace(**kw)
    cfg = get_config(arch, reduced=True).replace(**kw)
    ref, ours = jax_transformer.LM(jcfg), LM(cfg, device="cpu")
    params = ref.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    enc = (rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
           if cfg.is_encoder_decoder else None)
    logs = {"ref": [], "port": []}
    _record(monkeypatch, (jax_layers, jax_ssd, jax_transformer), logs["ref"])
    _record(monkeypatch, (layers, ssd, transformer), logs["port"])
    with jax_sharding.sharding_ctx(jax_local_mesh(1, 1), jax_sharding.SERVE_RULES):
        _, cache = ref.prefill(params, jnp.asarray(toks[:, :8]),
                               enc_embeds=None if enc is None else jnp.asarray(enc))
        ref.decode_step(params, cache, jnp.asarray(toks[:, 8:]))
    with sharding.sharding_ctx(make_local_mesh(1, 1, device_type="cpu"), sharding.SERVE_RULES):
        _, cache = ours.prefill(tparams, torch.from_numpy(toks[:, :8]),
                                enc_embeds=None if enc is None else torch.from_numpy(enc))
        ours.decode_step(tparams, cache, torch.from_numpy(toks[:, 8:]))
    assert len(logs["port"]) > 5
    assert logs["port"] == logs["ref"]


# --- int8 compression -----------------------------------------------------------

@pytest.mark.parametrize("seed,shape,scale", [(0, (7,), 1.0), (1, (64, 33), 1e-3),
                                             (2, (3, 5, 8), 300.0), (3, (1,), 1e-30),
                                             (4, (1000,), 1.0)])
def test_quantize_and_ef_compress_bit_equal_reference(seed, shape, scale):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    err = (rng.standard_normal(shape) * scale * 1e-2).astype(np.float32)
    q, s = compress.quantize_int8(torch.from_numpy(x))
    jq, js = jax_compress.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    got = compress.ef_compress(torch.from_numpy(x), torch.from_numpy(err))
    want = jax_compress.ef_compress(jnp.asarray(x), jnp.asarray(err))
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=2, max_size=64))
def test_ef_identity_invariant(vals):
    """x + err == deq(q) + new_err (error feedback loses nothing)."""
    x = torch.tensor(vals, dtype=torch.float32)
    err = torch.zeros_like(x)
    q, scale, new_err = compress.ef_compress(x, err)
    lhs = (x + err).numpy()
    rhs = (compress.dequantize_int8(q, scale) + new_err).numpy()
    np.testing.assert_allclose(lhs, rhs, atol=1e-5 * (1 + np.abs(lhs).max()))


@settings(max_examples=20, deadline=None, derandomize=True)
@given(st.integers(0, 2**31 - 1))
def test_ef_error_accumulation_bounded(seed):
    """Repeated EF compression of the same signal: the residual stays
    bounded by one quantization step (no drift)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(32).astype(np.float32))
    err = torch.zeros_like(x)
    for _ in range(10):
        q, scale, err = compress.ef_compress(x, err)
        assert float(err.abs().max()) <= float(scale) * 1.01


@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False), min_size=1, max_size=32))
def test_quantize_int8_range_and_scale(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    q, scale = compress.quantize_int8(x)
    assert q.dtype == torch.int8
    assert int(q.to(torch.int32).abs().max()) <= 127
    err = (compress.dequantize_int8(q, scale) - x).abs().numpy()
    assert err.max() <= float(scale) * 0.5 + 1e-6


@settings(max_examples=100, deadline=None, derandomize=True)
@given(
    dims=st.lists(st.integers(1, 512), min_size=1, max_size=4),
    data=st.sampled_from([1, 2, 4, 8, 16]),
    model=st.sampled_from([1, 2, 4, 8, 16]),
)
def test_spec_for_always_valid(dims, data, model):
    """Every produced spec divides dims, never reuses a mesh axis, and equals
    the reference's."""
    names = ["fsdp", "heads", "ff", "vocab"][: len(dims)]
    mesh = _FakeMesh(("data", data), ("model", model))
    spec = sharding.spec_for(tuple(dims), tuple(names), sharding.TRAIN_RULES, mesh)
    assert tuple(spec) == tuple(jax_sharding.spec_for(tuple(dims), tuple(names),
                                                      jax_sharding.TRAIN_RULES, mesh))
    used = []
    for dim, entry in zip(dims, spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            assert a not in used, (spec, dims)
            used.append(a)
            size *= mesh.shape[a]
        assert dim % size == 0, (spec, dims)


def test_one_rank_mean_is_the_plain_dequantized_target(world1):
    rng = np.random.default_rng(0)
    grads = {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
             "b": {"c": torch.from_numpy(rng.standard_normal(11).astype(np.float32))}}
    errs = compress.init_error_tree(grads)
    errs["a"] += 0.01
    wire = compress.WireCount()
    mean, new_err = compress.tree_ef_allreduce_mean(grads, errs, None, wire)
    for key in ("a",):
        target = grads[key] + errs[key]
        deq = compress.dequantize_int8(*compress.quantize_int8(target))
        assert torch.equal(mean[key], deq) and torch.equal(new_err[key], target - deq)
    assert wire.bytes == 0.0  # (N - 1) / N of anything at N = 1

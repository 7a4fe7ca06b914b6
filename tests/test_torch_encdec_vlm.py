"""seamless's encoder-decoder and internvl2's vision-patch frontend in the
port against the JAX package on the CPU, and the attention routes they put
on the path: flash attention at Sq != Sk and the cross-attention decode.

Models (reduced configs, float32): prefill, every cache leaf (the
read-only cross K/V included) and four greedy decode steps, as
tests/_lm_parity.py holds them (5e-4; integer leaves and tokens equal);
seamless with as many encoder frames as prompt tokens and with more,
internvl2 with a linear cache and with one small enough that its prefill
is ring-placed, as the live engine's cache is at full width.

Kernels' plain versions (float32, atol/rtol 1e-5: the same products in
another order): flash at Sq != Sk against the reference's Pallas kernel in
interpret mode at multiples of 128, and against its ``flash_attention_ref``
at other lengths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (TOL, check_prefill_and_decode, declared_shapes_match, inputs,
                        jax_model, leaves, port)
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.ops import sdpa_flash as jax_sdpa_flash
from repro.kernels.ref import flash_attention_ref as jax_flash_attention_ref
from repro.models.layers import _sdpa_jnp
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers
from repro_torch.models.transformer import LM

torch.set_num_threads(1)

ENCDEC = "seamless-m4t-large-v2"
VLM = "internvl2-76b"
KERNEL_TOL = 1e-5


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("enc_len", [None, 20])
def test_encdec_prefill_and_decode_match_jax(enc_len, impl):
    """Se == S (12 frames, as the live engine sends) and Se = 20 > S: the
    decode steps at positions 12..15 attend to all 20 encoder slots. impl
    "cuda" on CPU tensors runs the adapters' cross routes with the
    wrappers' plain versions."""
    cache = check_prefill_and_decode(ENCDEC, impl, enc_len=enc_len)
    se = enc_len or 12
    cross = cache["cross"]
    assert sorted(cross) == ["sub0"] and sorted(cross["sub0"]) == ["k", "pos_ids", "v"]
    assert tuple(cross["sub0"]["k"].shape) == (2, 2, se, 4, 16)  # (layers, B, Se, K, hd)
    assert cross["sub0"]["pos_ids"][0, 0].tolist() == list(range(se))


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("ring", [False, True])
def test_vlm_prefill_and_decode_match_jax(ring, impl):
    """8 patch positions before the prompt. With ``ring`` a 140-token
    prompt against kv_len 4: 148 positions outgrow the 132-slot cache, so
    the prefill keeps the last 132 at slots p % 132 and decode writes over
    the oldest."""
    run = {"prompt": 140, "kv_len": 4} if ring else {}
    cache = check_prefill_and_decode(VLM, impl, **run)
    pos = cache["blocks"]["sub0"]["attn"]["pos_ids"]
    S = 8 + run.get("prompt", 12)
    if ring:
        assert pos.shape[-1] == 132 and int(pos.min()) == S + 4 - 132
    else:
        assert int(pos.max()) == S + 3 and int((pos >= 0).sum(-1).max()) == S + 4


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_forward_matches_jax(arch):
    cfg, jm, jp = jax_model(arch)
    lm, tp = port(arch)
    tokens, kw = inputs(cfg, 2, 19, enc_len=23, seed=1)
    jl, _ = jax.jit(lambda p, t, kw: jm.forward(p, t, dtype=jnp.float32, **kw))(
        jp, jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in kw.items()})
    tl = lm.forward(tp, torch.as_tensor(tokens, dtype=torch.long), dtype=torch.float32,
                    **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert tl.shape[1] == 19 + cfg.frontend_tokens * (cfg.frontend == "vision_patches")
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_declares_the_jax_param_tree(arch):
    assert declared_shapes_match(arch)


def test_params_from_jax_carries_the_encoder_and_cross_params():
    _, _, jp = jax_model(ENCDEC)
    _, tp = port(ENCDEC)
    want = {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = leaves(tp)
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=str(path))
    assert sorted(tp["enc_blocks"]["sub0"]) == ["attn", "ln1", "ln2", "mlp"]
    assert tuple(tp["enc_final_norm"].shape) == (64,)
    sub = tp["blocks"]["sub0"]
    assert tuple(sub["ln_x"].shape) == (2, 64)
    assert sorted(sub["cross"]) == ["wk", "wo", "wq", "wv"]  # no q/k/v biases


def test_encdec_cache_spec_matches_jax():
    _, jm, _ = jax_model(ENCDEC)
    lm = LM(get_config(ENCDEC, reduced=True), device="cpu")
    want = {tuple(k.key for k in path): (tuple(s.shape), np.dtype(s.dtype).name)
            for path, s in jax.tree_util.tree_flatten_with_path(
                jm.cache_spec(3, 20, jnp.float32, enc_len=33))[0]}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in leaves(lm.init_cache(3, 20, torch.float32, enc_len=33)).items()}
    assert got == want


def _qkv(seed, B, Sq, Sk, H, K, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))


@pytest.mark.parametrize("Sq,Sk,causal", [(128, 256, False), (256, 128, False),
                                          (128, 256, True), (256, 128, True)])
def test_flash_sq_ne_sk_matches_the_pallas_kernel(Sq, Sk, causal):
    """The port's flash at Sq != Sk (its plain version on the CPU) against
    the TPU kernel in interpret mode: implicit positions arange(Sq) and
    arange(Sk), causal aligned at the top left."""
    q, k, v = _qkv(Sq + Sk + causal, 1, Sq, Sk, 4, 2, 16)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               interpret=True)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("Sq,Sk,causal,window,cap", [
    (5, 9, False, 0, 0.0), (5, 9, True, 0, 0.0), (37, 100, False, 0, 0.0),
    (100, 37, True, 0, 0.0), (200, 333, False, 0, 50.0), (9, 40, True, 4, 0.0)])
def test_flash_sq_ne_sk_matches_the_reference_oracle(Sq, Sk, causal, window, cap):
    q, k, v = _qkv(Sq * Sk, 2, Sq, Sk, 4, 2, 16)
    want = jax_flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window, softcap=cap)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                          causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("Sq", [1, 7])
def test_cross_route_attends_to_every_encoder_slot(Sq):
    """The adapter's cross routes (Sq 1: decode against the cross cache; Sq
    7: flash at Sq != Sk) against the dense non-causal oracle, with the
    decoder at positions below Se - 1: every encoder slot counts."""
    q, k, v = (torch.as_tensor(t) for t in _qkv(Sq, 2, Sq, 40, 4, 2, 16))
    q_pos = torch.arange(3, 3 + Sq, dtype=torch.int32)[None].expand(2, Sq)
    k_pos = torch.arange(40, dtype=torch.int32)[None].expand(2, 40)
    got = ops.sdpa_kernel(q, k, v, q_pos, k_pos, None, False, None, "cross")
    want = layers._sdpa_dense(q, k, v, q_pos, k_pos, None, False, None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=KERNEL_TOL, rtol=KERNEL_TOL)
    causal = layers._sdpa_dense(q, k, v, q_pos, k_pos, None, True, None)
    assert not np.allclose(got.numpy(), causal.numpy(), atol=1e-3)


def test_reference_pallas_cross_decode_masks_encoder_slots():
    """The reference's "pallas" adapter sends every Sq == 1 call to its decode
    kernel with lengths = q_pos and drops ``causal``, so a cross-attention
    decode at decoder position 5 of 128 encoder slots sees slots 0..5 only;
    its "jnp" default (which the port follows) sees all 128. A fault of the
    reference, left as it is."""
    q, k, v = _qkv(11, 2, 1, 128, 4, 2, 16)
    q_pos = np.full((2, 1), 5, np.int32)
    k_pos = np.broadcast_to(np.arange(128, dtype=np.int32), (2, 128)).copy()
    args = [jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)]
    jnp_out = np.asarray(_sdpa_jnp(*args, None, False, None))
    pallas_out = np.asarray(jax_sdpa_flash(*args, None, False, None))
    ours = ops.sdpa_kernel(*(torch.as_tensor(a) for a in (q, k, v, q_pos, k_pos)), None, False,
                           None, "cross").numpy()
    np.testing.assert_allclose(ours, jnp_out, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    assert not np.allclose(pallas_out, jnp_out, atol=1e-3)
    masked = np.asarray(_sdpa_jnp(*args, None, True, None))  # slots 0..5 only
    np.testing.assert_allclose(pallas_out, masked, atol=KERNEL_TOL, rtol=KERNEL_TOL)

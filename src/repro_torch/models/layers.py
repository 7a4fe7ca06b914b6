"""Dense neural layers of the decoder archs, on torch tensors.

Functions take parameter dicts in the JAX package's layout. Attention's
inner product goes through a registry of scaled-dot-product-attention
implementations: "plain" (``_sdpa_dense``, the oracle) lives here and
kernels/ops.py registers "cuda".
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamDecl

F32 = torch.float32
NEG_INF = -1e30  # finite mask value, as the reference and its kernels use

#: scaled-dot-product-attention implementations by name. Each takes
#: (q, k, v, q_pos, k_pos, window, causal, cap, site); ``site`` names the
#: call site ("prefill" | "decode") so a kernel adapter routes by
#: where it is called from, never by looking at tensor values.
SDPA_IMPL: dict = {}


# ---------------------------------------------------------------------------
# Norms / activations / rope
# ---------------------------------------------------------------------------

def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (w.to(F32) * xf * torch.rsqrt(var + eps)).to(x.dtype)


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if act == "gelu" else F.silu(x)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """(.., hd/2) rotation angles for given absolute positions."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=F32, device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=F32, device=positions.device), exps)
    return positions.to(F32)[..., None] * freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               interleaved: bool) -> torch.Tensor:
    """Rotary embedding. x: (B, S, N, hd); positions: (B, S).

    Interleaved pairs (2i, 2i+1) are the default; rotate-half pairs
    (i, i + hd/2) otherwise.
    """
    B, S, N, hd = x.shape
    ang = rope_angles(positions, hd, theta)[:, :, None, :]  # (B,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.to(F32)
    if interleaved:
        x1 = xf[..., 0::2]
        x2 = xf[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x1 * sin + x2 * cos
        out = torch.stack([r1, r2], dim=-1).reshape(B, S, N, hd)
    else:
        half = hd // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attn_decl(cfg: ModelConfig) -> dict:
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    decl = {
        "wq": ParamDecl((d, h, hd), ("fsdp", "heads", "q_param_hd"), fan_in=d),
        "wk": ParamDecl((d, k, hd), ("fsdp", "kv_heads", "kv_param_hd"), fan_in=d),
        "wv": ParamDecl((d, k, hd), ("fsdp", "kv_heads", "kv_param_hd"), fan_in=d),
        "wo": ParamDecl((h, hd, d), ("heads", "head_dim", "fsdp"), fan_in=h * hd),
    }
    if cfg.qkv_bias:
        decl["bq"] = ParamDecl((h, hd), ("heads", "head_dim"), init="zeros")
        decl["bk"] = ParamDecl((k, hd), ("kv_heads", "head_dim"), init="zeros")
        decl["bv"] = ParamDecl((k, hd), ("kv_heads", "head_dim"), init="zeros")
    return decl


def causal_window_mask(
    q_pos: torch.Tensor,  # (B, Sq) absolute positions of queries
    k_pos: torch.Tensor,  # (B, Sk) absolute positions of keys (-1 = empty slot)
    window: Optional[int],  # <=0 / None = global
    causal: bool = True,
) -> torch.Tensor:
    d = q_pos[:, :, None] - k_pos[:, None, :]  # (B, Sq, Sk)
    ok = k_pos[:, None, :] >= 0
    if causal:
        ok = ok & (d >= 0)
    if window is not None and window > 0:
        ok = ok & (d < window)
    return ok


def _sdpa_dense(q, k, v, q_pos, k_pos, window, causal, cap) -> torch.Tensor:
    """Materialized-scores attention: (B,Sq,H,hd) x (B,Sk,K,hd)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(F32), k.to(F32))
    scores = scores / math.sqrt(hd)
    scores = softcap(scores, cap)
    mask = causal_window_mask(q_pos, k_pos, window, causal)
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(NEG_INF, dtype=F32, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def _sdpa_plain(q, k, v, q_pos, k_pos, window, causal, cap, site):
    return _sdpa_dense(q, k, v, q_pos, k_pos, window, causal, cap)


SDPA_IMPL["plain"] = _sdpa_plain


def sdpa(q, k, v, *, q_pos, k_pos, window, causal, cap, site: str,
         impl: str = "plain"):
    """Dispatch to a registered implementation; an unknown name raises
    ``KeyError``."""
    return SDPA_IMPL[impl](q, k, v, q_pos, k_pos, window, causal, cap, site)


def attention(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S)
    window: Optional[int] = None,
    cache: Optional[dict] = None,  # {"k","v","pos_ids"} per-layer slices
    lengths: Optional[torch.Tensor] = None,  # (B,) current lengths (decode)
    impl: str = "plain",
):
    """Causal self-attention with rope for prefill/forward/decode.

    Returns (out, new_cache). new_cache is None unless a cache was given or
    prefill requested one via the ``cache={}`` sentinel. On decode the new
    K/V and pos_ids are written into the given cache tensors IN PLACE, and
    those same tensors are returned.
    """
    B, S, D = x.shape
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)

    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_interleaved)
    if cache is not None and "k" in cache:
        # decode: write the S new entries into ring/linear slots
        # lengths % Smax onward. The reference blends a one-hot over all
        # Smax slots (cache * (1 - oh) + oh @ new); for finite values
        # that is exactly an overwrite of the written slots, which an
        # indexed in-place write gives without touching the others.
        ck, cv, pos_ids = cache["k"], cache["v"], cache["pos_ids"]
        Smax = ck.shape[1]
        ar = torch.arange(S, dtype=lengths.dtype, device=x.device)
        slot = (lengths[:, None] + ar[None, :]) % Smax  # (B, S)
        rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
        ck[rows, slot] = k.to(ck.dtype)
        cv[rows, slot] = v.to(cv.dtype)
        pos_ids[rows, slot] = positions.to(pos_ids.dtype)
        new_cache = {"k": ck, "v": cv, "pos_ids": pos_ids}
        k, v, k_pos = ck, cv, pos_ids
        site = "decode"
    else:
        # prefill (cache={} asks for one: keys are their own slots) or forward
        new_cache = {"k": k, "v": v, "pos_ids": positions} if cache is not None else None
        k_pos = positions
        site = "prefill"

    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_interleaved)
    out = sdpa(
        q, k, v,
        q_pos=positions, k_pos=k_pos, window=window, causal=True,
        cap=cfg.attn_logit_softcap, site=site, impl=impl,
    )
    if cfg.attn_out_scale is not None:
        out = out * cfg.attn_out_scale
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_decl(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": ParamDecl((d, f), ("fsdp", "ff"), fan_in=d),
        "wg": ParamDecl((d, f), ("fsdp", "ff"), fan_in=d),
        "wo": ParamDecl((f, d), ("ff", "fsdp"), fan_in=f),
    }


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dt))
    g = torch.einsum("bsd,df->bsf", x, p["wg"].to(dt))
    h = activate(g, cfg.act) * h
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))

"""Mamba2 state-space duality (SSD): chunked scan, decode recurrence and the
mixer layer, on torch tensors.

Same names and layouts as the JAX package's ``models/ssd.py`` (arXiv
2405.21060): the sequence is split into chunks; within a chunk the
recurrence is a masked, decay-weighted quadratic form, and the chunk states
are carried from one chunk to the next. A Python loop over the chunks takes
the place of ``lax.scan``.

The chunked scan goes through a registry of implementations, ``SSD_IMPL``:
"plain" (``ssd_chunked``, the oracle) lives here and kernels/ops.py
registers "cuda". Each takes (x, dt, A, B_, C_, chunk, h0). The reference's
``mamba_apply`` takes ``impl`` but always runs its jnp scan; here ``impl``
picks the entry, so on a CUDA device every prefill runs the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import spmd
from ..parallel.sharding import shard
from .config import ModelConfig
from .params import ParamDecl

F32 = torch.float32

#: chunked-scan implementations by name; an unknown name raises ``KeyError``
SSD_IMPL: dict = {}


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) positive step sizes
    A: torch.Tensor,  # (H,) negative continuous-time decay
    B_: torch.Tensor,  # (B, S, H, N) input matrix (head-expanded)
    C_: torch.Tensor,  # (B, S, H, N) output matrix (head-expanded)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in x's type, final state (B,H,P,N) float32)."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc, Q = S // chunk, chunk

    xr = x.reshape(Bsz, nc, Q, H, P).to(F32)
    dtr = dt.reshape(Bsz, nc, Q, H).to(F32)
    Br = B_.reshape(Bsz, nc, Q, H, N).to(F32)
    Cr = C_.reshape(Bsz, nc, Q, H, N).to(F32)
    Af = A.to(F32)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))[None, :, :, None]
    h = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device) if h0 is None else h0.to(F32)

    ys = []
    for c in range(nc):
        x_c, dt_c, B_c, C_c = xr[:, c], dtr[:, c], Br[:, c], Cr[:, c]  # (B,Q,H,*)
        cs = torch.cumsum(dt_c * Af, dim=1)  # (B,Q,H) inclusive, negative
        # intra: L[q,k] = exp(cs_q - cs_k) for q >= k. The upper triangle
        # is masked to -inf before the exp (exp gives exactly 0 there): its
        # exp may overflow to inf, which the reference's where-after-exp
        # keeps out of the forward value but not out of the gradient
        # (0 * inf = NaN)
        diff = cs[:, :, None, :] - cs[:, None, :, :]  # (B,Q,K,H)
        L = torch.exp(torch.where(tri, diff, float("-inf")))
        scores = torch.einsum("bqhn,bkhn->bqkh", C_c, B_c)
        M = scores * L * dt_c[:, None, :, :]
        y = torch.einsum("bqkh,bkhp->bqhp", M, x_c)
        # inter: contribution of the carried state
        y = y + torch.einsum("bqhn,bhpn->bqhp", C_c * torch.exp(cs)[..., None], h)
        # chunk summary -> next state
        cs_last = cs[:, -1:, :]
        w = torch.exp(cs_last - cs) * dt_c  # (B,Q,H)
        state_c = torch.einsum("bqh,bqhp,bqhn->bhpn", w, x_c, B_c)
        h = torch.exp(cs_last[:, 0, :])[:, :, None, None] * h + state_c
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y.to(x.dtype), h


SSD_IMPL["plain"] = ssd_chunked


def ssd_decode_step(
    h: torch.Tensor,  # (B, H, P, N)
    x: torch.Tensor,  # (B, H, P)
    dt: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    B_: torch.Tensor,  # (B, H, N)
    C_: torch.Tensor,  # (B, H, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. Returns (y (B,H,P), new state)."""
    hf = h.to(F32)
    dA = torch.exp(dt.to(F32) * A.to(F32))  # (B,H)
    upd = dt.to(F32)[:, :, None, None] * torch.einsum(
        "bhp,bhn->bhpn", x.to(F32), B_.to(F32)
    )
    h_new = dA[:, :, None, None] * hf + upd
    y = torch.einsum("bhpn,bhn->bhp", h_new, C_.to(F32))
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# Mamba2 mixer layer (projections + conv + SSD + gated norm)
# ---------------------------------------------------------------------------

def mamba_decl(cfg: ModelConfig) -> dict:
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, W = cfg.ssm_heads, cfg.conv_width
    conv_ch = di + 2 * ns  # x, B, C channels (single group)
    return {
        "in_proj": ParamDecl((d, 2 * di + 2 * ns + nh), ("fsdp", "ssm_inner"), fan_in=d),
        "conv_w": ParamDecl((W, conv_ch), (None, "conv_ch"), fan_in=W),
        "conv_b": ParamDecl((conv_ch,), ("conv_ch",), init="zeros"),
        "A_log": ParamDecl((nh,), ("ssm_heads",), init="zeros"),  # A = -1
        "D": ParamDecl((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDecl((nh,), ("ssm_heads",), init="zeros"),
        "norm_w": ParamDecl((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamDecl((di, d), ("ssm_inner", "fsdp"), fan_in=di),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as the reference's shifted sum (no cuDNN, so no
    TF32). u: (B,S,C), w: (W,C)."""
    W = w.shape[0]
    up = F.pad(u, (0, 0, W - 1, 0))
    S = u.shape[1]
    out = sum(up[:, i : i + S, :] * w[i][None, None, :] for i in range(W))
    return out + b[None, None, :]


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, ns = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di : 2 * di]
    B_ = zxbcdt[..., 2 * di : 2 * di + ns]
    C_ = zxbcdt[..., 2 * di + ns : 2 * di + 2 * ns]
    dt = zxbcdt[..., 2 * di + 2 * ns :]
    return z, xs, B_, C_, dt


def _mixer_in(p: dict, zxbcdt: torch.Tensor, cfg: ModelConfig, conv_state, want_cache: bool):
    """From the input projection to the scan's inputs: the split, the causal
    conv (one step against ``conv_state`` (B, W-1, conv_ch) in decode) and
    the step sizes. Returns (z, xs_c (B,S,H,P), B_c, C_c (B,S,N), dt_act
    (B,S,H) float32, the new conv state or None)."""
    Bsz, S = zxbcdt.shape[:2]
    dt_ = zxbcdt.dtype
    di, ns, nh, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    W = cfg.conv_width
    z, xs, B_, C_, dtr = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, B_, C_], dim=-1)  # (B,S,conv_ch)
    if conv_state is not None:
        full = torch.cat([conv_state.to(dt_), conv_in], dim=1)
        conv_out = torch.einsum(
            "bwc,wc->bc", full.to(F32), p["conv_w"].to(F32)
        ) + p["conv_b"].to(F32)
        conv_out = conv_out[:, None, :].to(dt_)
        new_conv = full[:, 1:, :]
    else:
        conv_out = _causal_conv(conv_in, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
        new_conv = conv_in[:, -(W - 1):, :] if want_cache else None
    conv_out = F.silu(conv_out)

    xs_c = conv_out[..., :di].reshape(Bsz, S, nh, P)
    B_c = conv_out[..., di : di + ns]  # (B,S,N) single group
    C_c = conv_out[..., di + ns :]
    dt_act = F.softplus(dtr.to(F32) + p["dt_bias"].to(F32))  # (B,S,H)
    return z, xs_c, B_c, C_c, dt_act, new_conv


def _scan(impl: str, xs_c, dt_act, A, B_c, C_c, chunk: int, h0):
    """The chunked scan of (B,S,...) inputs, right-padded to a whole number
    of chunks; returns (y (B,S,H,P), final state)."""
    Bsz, S, nh, _ = xs_c.shape
    ns = B_c.shape[-1]
    pad = (-S) % chunk
    xp, Bp, Cp, dtp = xs_c, B_c, C_c, dt_act
    if pad:
        # right-pad with dt=0: exp(0)=1 leaves the state untouched and
        # padded outputs are dropped below
        xp = F.pad(xs_c, (0, 0, 0, 0, 0, pad))
        Bp = F.pad(B_c, (0, 0, 0, pad))
        Cp = F.pad(C_c, (0, 0, 0, pad))
        dtp = F.pad(dt_act, (0, 0, 0, pad))
    # the single group broadcast over heads, as a view (head stride 0)
    Sp = S + pad
    Bh = Bp[:, :, None, :].expand(Bsz, Sp, nh, ns)
    Ch = Cp[:, :, None, :].expand(Bsz, Sp, nh, ns)
    y, h_new = SSD_IMPL[impl](xp, dtp, A, Bh, Ch, chunk, h0)
    if pad:
        y = y[:, :S]
    return y, h_new


def _mixer_out(p: dict, y, xs_c, z, cfg: ModelConfig):
    """The skip through D and mamba2's gated RMSNorm (norm before gate):
    (B,S,H,P) -> (B,S,d_inner) in z's type."""
    Bsz, S = y.shape[:2]
    dt_ = z.dtype
    y = y + xs_c * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(Bsz, S, cfg.d_inner)
    yf = y.to(F32) * F.silu(z.to(F32))
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (p["norm_w"].to(F32) * yf * torch.rsqrt(var + cfg.norm_eps)).to(dt_)


def mamba_apply(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    cfg: ModelConfig,
    cache: Optional[dict] = None,  # {"ssm": (B,H,P,N), "conv": (B,W-1,conv_ch)}
    want_cache: bool = False,
    impl: str = "plain",
):
    """Mamba2 mixer. Prefill/train when cache is None or want_cache;
    single-step decode when cache holds state and S == 1.

    Returns (out, new_cache). On decode the new state is written into the
    given cache tensors IN PLACE, and those same tensors are returned.

    A DTensor x runs the projections on local shards (``spmd.einsum``),
    the conv and the gated norm on each rank's rows, and the scan (or the
    decode step) on each rank's own heads: ``ssm_heads`` over "model"."""
    if spmd.is_dtensor(x):
        return spmd.mamba_apply(p, x, cfg=cfg, cache=cache, want_cache=want_cache, impl=impl)
    Bsz, S, D = x.shape
    dt_ = x.dtype

    zxbcdt = shard(torch.einsum("bsd,de->bse", x, p["in_proj"].to(dt_)),
                   "batch", "seq", "ssm_inner")
    decode = cache is not None and "ssm" in cache and S == 1
    z, xs_c, B_c, C_c, dt_act, new_conv = _mixer_in(
        p, zxbcdt, cfg, cache["conv"] if decode else None, want_cache)
    A = -torch.exp(p["A_log"].to(F32))  # (H,)

    if decode:
        nh, ns = cfg.ssm_heads, cfg.ssm_state
        y1, h_new = ssd_decode_step(
            cache["ssm"], xs_c[:, 0], dt_act[:, 0], A,
            B_c[:, 0, None, :].expand(Bsz, nh, ns), C_c[:, 0, None, :].expand(Bsz, nh, ns),
        )
        y = y1[:, None]  # (B,1,H,P)
        cache["ssm"].copy_(h_new)
        cache["conv"].copy_(new_conv)
        new_cache = {"ssm": cache["ssm"], "conv": cache["conv"]}
    else:
        h0 = cache["ssm"] if (cache is not None and "ssm" in cache) else None
        y, h_new = _scan(impl, xs_c, dt_act, A, B_c, C_c, min(cfg.ssm_chunk, S), h0)
        new_cache = {"ssm": h_new, "conv": new_conv} if want_cache else None

    yn = _mixer_out(p, y, xs_c, z, cfg)
    out = torch.einsum("bse,ed->bsd", yn, p["out_proj"].to(dt_))
    return shard(out, "batch", "seq", "embed"), new_cache


def mamba_cache_decl(cfg: ModelConfig, batch: int, dtype) -> dict:
    """(shape, dtype) for one layer's mamba cache."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "ssm": ((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), F32),
        "conv": ((batch, cfg.conv_width - 1, conv_ch), dtype),
    }

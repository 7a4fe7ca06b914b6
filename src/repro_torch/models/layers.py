"""Neural layers of the decoder archs (attention, MLP and MoE FFNs), on
torch tensors.

Functions take parameter dicts in the JAX package's layout. Attention's
inner product goes through a registry of scaled-dot-product-attention
implementations: "plain" (``_sdpa_dense``, the oracle) lives here and
kernels/ops.py registers "cuda".

``coll_out`` tags the outputs that the reference tags with
``checkpoint_name(x, "coll_out")``: the attention and MLP outputs, and the
MoE experts' and layer's outputs. The tag is an op of its own,
``torch.ops.repro_torch.coll_out``, that returns a view of its input (no
copy) and passes the gradient through, so that the "coll" remat policy
(models/transformer.py) can name what it saves.

``shard`` marks the activations that the reference constrains to a layout,
at the same sites with the same logical axes (``parallel/sharding.py``); on
one device it returns its input.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from ..parallel import spmd
from ..parallel.sharding import shard
from ..parallel.spmd import einsum
from .config import ModelConfig
from .params import ParamDecl

F32 = torch.float32
NEG_INF = -1e30  # finite mask value, as the reference and its kernels use

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("coll_out(Tensor(a) x) -> Tensor(a)")
_LIB.impl("coll_out", lambda x: torch.ops.aten.alias.default(x), "CompositeExplicitAutograd")


class _CollOut(torch.autograd.Function):
    """The tag's autograd: the identity both ways."""

    @staticmethod
    def forward(ctx, x):
        with torch._C._AutoDispatchBelowAutograd():
            return torch.ops.repro_torch.coll_out(x)

    @staticmethod
    def backward(ctx, g):
        return g


_LIB.impl("coll_out", _CollOut.apply, "Autograd")


def coll_out(x: torch.Tensor) -> torch.Tensor:
    """x, tagged for the "coll" remat policy where a gradient may be taken
    (the only place a policy looks); x itself otherwise, so that serving
    pays nothing for it. A DTensor's local shard carries the tag."""
    if not torch.is_grad_enabled():
        return x
    return spmd.local_apply(torch.ops.repro_torch.coll_out, x)

#: scaled-dot-product-attention implementations by name. Each takes
#: (q, k, v, q_pos, k_pos, window, causal, cap, site); ``site`` names the
#: call site ("prefill" | "decode" | "cross") so a kernel adapter routes by
#: where it is called from, never by looking at tensor values.
SDPA_IMPL: dict = {}

#: the gathered MoE decode's expert products by name (``_moe_gathered``).
#: Each takes (x (B, D), eidx (B, K) int64, gate (B, K) in x's type, wi, wg
#: (E_l, D, F_l), wo (E_l, F_l, D); e0, num_experts, act) and returns y (B,
#: D): the sum over k of gate[b,k] (act(x_b wg[e]) * (x_b wi[e])) wo[e], e =
#: eidx[b,k] - e0, where a choice outside [e0, e0 + E_l) adds nothing.
#: "plain" (``_gathered_loop``) lives here; kernels/ops.py registers "cuda"
#: and kernels/trace.py "trace".
MOE_IMPL: dict = {}


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
    # a fill, not torch.tensor: that copies from host memory and waits for the
    # device, which a CUDA graph's capture (launch/graphs.py) refuses
    freq = torch.pow(torch.full((), theta, dtype=F32, device=positions.device), exps)
    return positions.to(F32)[..., None] * freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               interleaved: bool) -> torch.Tensor:
    """Rotary embedding. x: (B, S, N, hd); positions: (B, S).

    Interleaved pairs (2i, 2i+1) are the default; rotate-half pairs
    (i, i + hd/2) otherwise. A DTensor rotates its local rows with its
    head_dim whole on every rank: a head_dim split (the bias of the
    head-dim fallback passes its split on) is all-gathered first, since a
    rotate-half pair, or an interleaved one under an odd split, would
    straddle two ranks.
    """
    if spmd.is_dtensor(x):
        x = spmd.replicate(x, [m for m, p in enumerate(x.placements)
                               if p.is_shard() and p.dim == 3])
        pos = spmd.local_rows_of(positions, x)
        return spmd.local_apply(lambda t: apply_rope(t, pos, theta, interleaved), x)
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

def attn_decl(cfg: ModelConfig, cross: bool = False) -> dict:
    """q/k/v/o projections; cross-attention has no q/k/v biases."""
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    decl = {
        "wq": ParamDecl((d, h, hd), ("fsdp", "heads", "q_param_hd"), fan_in=d),
        "wk": ParamDecl((d, k, hd), ("fsdp", "kv_heads", "kv_param_hd"), fan_in=d),
        "wv": ParamDecl((d, k, hd), ("fsdp", "kv_heads", "kv_param_hd"), fan_in=d),
        "wo": ParamDecl((h, hd, d), ("heads", "head_dim", "fsdp"), fan_in=h * hd),
    }
    if cfg.qkv_bias and not cross:
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
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def _sdpa_dense_lse(q, k, v, q_pos, k_pos, window, causal, cap):
    """``_sdpa_dense`` in float32 throughout, with each row's log-sum-exp:
    (out (B,Sq,H,hd) float32, lse (B,Sq,H) of the scaled, capped scores
    over the keys the mask keeps, -inf where it keeps none; such a row's
    out is the mean of V over every key, as ``_sdpa_dense`` gives it)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(B, Sq, K, H // K, hd).to(F32),
                     k.to(F32)) / math.sqrt(hd)
    s = softcap(s, cap)
    mask = causal_window_mask(q_pos, k_pos, window, causal)[:, None, None]
    lse = torch.logsumexp(torch.where(mask, s, float("-inf")), dim=-1)  # (B,K,G,Sq)
    probs = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(F32))
    return out.reshape(B, Sq, H, hd), lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def _sdpa_plain(q, k, v, q_pos, k_pos, window, causal, cap, site, lse=False):
    if lse:
        return _sdpa_dense_lse(q, k, v, q_pos, k_pos, window, causal, cap)
    return _sdpa_dense(q, k, v, q_pos, k_pos, window, causal, cap)


SDPA_IMPL["plain"] = _sdpa_plain


def sdpa(q, k, v, *, q_pos, k_pos, window, causal, cap, site: str,
         impl: str = "plain"):
    """Dispatch to a registered implementation; an unknown name raises
    ``KeyError``. DTensors run it on each rank's local heads
    (``spmd.local_sdpa``)."""
    if spmd.is_dtensor(q):
        return spmd.local_sdpa(SDPA_IMPL[impl], q, k, v, q_pos, k_pos, window, causal, cap,
                               site)
    return SDPA_IMPL[impl](q, k, v, q_pos, k_pos, window, causal, cap, site)


def quantize_kv(t: torch.Tensor):
    """Per-(slot, head) symmetric int8 over head_dim. t: (B,S,K,hd).
    Returns (codes (B,S,K,hd) int8, scales (B,S,K) float32); ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    tf = t.to(F32)
    scale = torch.clamp(torch.amax(torch.abs(tf), dim=-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dt) -> torch.Tensor:
    return (q.to(F32) * scale[..., None]).to(dt)


def attention(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S)
    window: Optional[int] = None,
    cache: Optional[dict] = None,  # {"k","v","pos_ids"} or int8 leaves, per layer
    lengths: Optional[torch.Tensor] = None,  # (B,) current lengths (decode)
    kv_override: Optional[tuple] = None,  # cross-attention: (k, v, k_pos) precomputed
    causal: bool = True,
    use_rope: bool = True,
    impl: str = "plain",
    kv_quant: bool = False,
):
    """Attention for prefill/forward/decode, and cross-attention against the
    precomputed K/V of ``kv_override`` (call site "cross").

    Returns (out, new_cache). new_cache is None unless a cache was given or
    prefill requested one via the ``cache={}`` sentinel, and never for
    cross-attention. With ``kv_quant`` prefill stores int8 K/V and their
    float32 scales ("k_q", "v_q", "k_s", "v_s", per (slot, head)) and
    attends to the dequantized values, exactly what decode will read. On
    decode the new entries and pos_ids are written into the given cache
    tensors IN PLACE, and those same tensors are returned; an int8 cache
    (one holding "k_q") is then dequantized whole in a pass of its own
    before the attention, as the reference dequantizes before its kernel.
    """
    B, S, D = x.shape
    dt = x.dtype
    q = einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if "bq" in p:
        q = spmd.add_bias(q, p["bq"].to(dt))
    q = shard(q, "batch", "seq", "act_heads", "act_head_dim")

    if kv_override is not None:
        k, v, k_pos = kv_override
        new_cache = None
        site = "cross"
    else:
        k = einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
        v = einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
        if "bk" in p:
            k = spmd.add_bias(k, p["bk"].to(dt))
            v = spmd.add_bias(v, p["bv"].to(dt))
        if use_rope:
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_interleaved)
        k = shard(k, "batch", "seq", "act_kv_heads", "act_head_dim")
        v = shard(v, "batch", "seq", "act_kv_heads", "act_head_dim")
        if cache is not None and ("k" in cache or "k_q" in cache) and spmd.is_dtensor(x):
            k, v, k_pos, new_cache = spmd.cache_write(cache, k, v, positions, lengths, dt)
            site = "decode"
        elif cache is not None and ("k" in cache or "k_q" in cache):
            # decode: write the S new entries into ring/linear slots
            # lengths % Smax onward. The reference blends a one-hot over all
            # Smax slots (cache * (1 - oh) + oh @ new, or a select); for
            # finite values that is exactly an overwrite of the written
            # slots, which an indexed in-place write gives without touching
            # the others.
            pos_ids = cache["pos_ids"]
            Smax = pos_ids.shape[1]
            ar = torch.arange(S, dtype=lengths.dtype, device=x.device)
            slot = (lengths[:, None] + ar[None, :]) % Smax  # (B, S)
            rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
            pos_ids[rows, slot] = positions.to(pos_ids.dtype)
            if "k_q" in cache:
                new_cache = dict(cache)
                for name, t in (("k", k), ("v", v)):
                    codes, scales = quantize_kv(t)
                    cache[f"{name}_q"][rows, slot] = codes
                    cache[f"{name}_s"][rows, slot] = scales
                k = dequantize_kv(cache["k_q"], cache["k_s"], dt)
                v = dequantize_kv(cache["v_q"], cache["v_s"], dt)
            else:
                ck, cv = cache["k"], cache["v"]
                ck[rows, slot] = k.to(ck.dtype)
                cv[rows, slot] = v.to(cv.dtype)
                new_cache = {"k": ck, "v": cv, "pos_ids": pos_ids}
                k, v = ck, cv
            k_pos = pos_ids
            site = "decode"
        else:
            # prefill (cache={} asks for one: keys are their own slots) or forward
            if cache is None:
                new_cache = None
            elif kv_quant:
                (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
                new_cache = {"k_q": kq, "v_q": vq, "k_s": ks, "v_s": vs, "pos_ids": positions}
                k, v = dequantize_kv(kq, ks, dt), dequantize_kv(vq, vs, dt)
            else:
                new_cache = {"k": k, "v": v, "pos_ids": positions}
            k_pos = positions
            site = "prefill"

    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_interleaved)
    out = sdpa(
        q, k, v,
        q_pos=positions, k_pos=k_pos, window=window, causal=causal,
        cap=cfg.attn_logit_softcap, site=site, impl=impl,
    )
    if cfg.attn_out_scale is not None:
        out = out * cfg.attn_out_scale
    y = coll_out(shard(einsum("bshk,hkd->bsd", out, p["wo"].to(dt)),
                       "batch", "seq", "embed"))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP / MoE
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
    h = einsum("bsd,df->bsf", x, p["wi"].to(dt))
    g = einsum("bsd,df->bsf", x, p["wg"].to(dt))
    h = shard(activate(g, cfg.act) * h, "batch", "seq", "ff")
    y = einsum("bsf,fd->bsd", h, p["wo"].to(dt))
    return coll_out(shard(y, "batch", "seq", "embed"))


def moe_decl(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDecl((d, e), ("fsdp", None), fan_in=d),
        "wi": ParamDecl((e, d, f), ("experts", "fsdp", "moe_ff"), fan_in=d),
        "wg": ParamDecl((e, d, f), ("experts", "fsdp", "moe_ff"), fan_in=d),
        "wo": ParamDecl((e, f, d), ("experts", "moe_ff", "fsdp"), fan_in=f),
    }


def moe_capacity(tokens: int, k: int, e: int, cf: float) -> int:
    c = int(math.ceil(tokens * k * cf / e))
    return max(8, -(-c // 8) * 8)  # round up to 8 lanes


def moe_probs(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """Router probs (.., E) in float32. On DTensors every "model" rank
    computes them all (the router is replicated there)."""
    if spmd.is_dtensor(x):
        eq = "gtd,de->gte" if x.dim() == 3 else "td,de->te"
        return torch.softmax(einsum(eq, x.to(F32), router.to(F32)), dim=-1)
    return torch.softmax(x.to(F32) @ router.to(F32), dim=-1)


def moe_topk(probs: torch.Tensor, k: int):
    """The top-k (gate, expert) pairs of ``probs``, largest first. A stable
    descending sort breaks ties toward the lower expert index, as
    ``jax.lax.top_k`` does (``torch.topk`` does not promise an order among
    equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Router probs (.., E) in float32 and the top-k (gate, expert) pairs,
    largest first (``moe_probs``, ``moe_topk``)."""
    probs = moe_probs(x, router)
    return (probs,) + moe_topk(probs, k)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, impl: str = "plain"):
    """Token-choice top-k MoE; returns (y, aux_loss).

    The reference's three branches, with its gates: a decode batch of at
    most 16 tokens on an arch whose expert count is not a multiple of 16
    runs each token's products on its chosen experts' weights alone, with
    no capacity (``_moe_gathered``, whose expert products go through
    ``MOE_IMPL[impl]``); any other decode step routes the batch as one
    group; prefill routes each batch row as a group, with a capacity per
    expert (``_moe_grouped``)."""
    B, S, D = x.shape
    gathered = S == 1 and B <= 16 and cfg.num_experts % 16 != 0
    if spmd.is_dtensor(x):
        return spmd.moe_apply(p, x, cfg, gathered=gathered, impl=impl)
    if gathered:
        return _moe_gathered(p, x, cfg, impl)
    if S == 1:  # decode: one group over the (small) batch
        y, aux = _moe_grouped(p, x.reshape(1, B, D), cfg)
        return y.reshape(B, S, D), aux
    return _moe_grouped(p, x, cfg)


def _moe_gathered(p: dict, x: torch.Tensor, cfg: ModelConfig, impl: str,
                  experts: Optional[range] = None, probs: Optional[torch.Tensor] = None):
    """Dropless per-token expert products. x: (B, 1, D).

    The reference copies each token's K experts' weights out as (B, K, D,
    F) (``jnp.take``) and contracts over k and f at once. Here the router's
    top-k and gates are taken on the device and the products go to
    ``MOE_IMPL[impl]``, which reads the chosen experts' weights in place:
    the plain loop (``_gathered_loop``) after reading the ids to the host,
    the kernel (``kernels/moe_decode.py``) on the card. The copy would
    write every chosen weight and read it twice.

    ``experts``: the expert ids whose weights ``p`` holds (expert
    parallelism: a rank's own), ``p``'s rows in that order; a token's
    choices of other experts are left to their ranks (zero here).
    ``probs``: the router's (B, E), where the caller has them."""
    dt = x.dtype
    if probs is None:
        probs = moe_probs(x[:, 0], p["router"])
    gate, eidx = moe_topk(probs, cfg.top_k)  # (B, K)
    gate = (gate / torch.sum(gate, dim=-1, keepdim=True)).to(dt)
    y = MOE_IMPL[impl](x[:, 0], eidx, gate, p["wi"], p["wg"], p["wo"],
                       e0=0 if experts is None else experts.start,
                       num_experts=cfg.num_experts, act=cfg.act)
    return y[:, None], torch.zeros((), dtype=F32, device=x.device)  # no aux loss on decode


def _gathered_loop(x, eidx, gate, wi, wg, wo, *, e0: int = 0, num_experts: Optional[int] = None,
                   act: str = "silu") -> torch.Tensor:
    """``MOE_IMPL["plain"]``: the chosen ids come to the host once a call
    (``_chosen``), and each (token, choice) pair's products read its
    expert's weights in place; a token's K outputs are added in k order.
    x (B, D); returns y (B, D) in x's type."""
    D = x.shape[1]
    dt = x.dtype
    rows = []
    for b, chosen in enumerate(_chosen(eidx, num_experts or e0 + wi.shape[0])):
        xb = x[b:b + 1]  # (1, D)
        yb = None
        for k, e in enumerate(chosen):
            e -= e0
            if not 0 <= e < wi.shape[0]:
                continue
            h = activate(xb @ wg[e].to(dt), act) * (xb @ wi[e].to(dt))
            yk = (h * gate[b, k]) @ wo[e].to(dt)
            yb = yk if yb is None else yb + yk
        rows.append(yb if yb is not None else torch.zeros((1, D), dtype=dt, device=x.device))
    return torch.cat(rows)


MOE_IMPL["plain"] = _gathered_loop


def _chosen(eidx: torch.Tensor, E: int) -> list:
    """The chosen experts (B, K) as Python lists: the plain loop's one
    device-to-host read. A step traced under ``FakeTensorMode`` (no values:
    the production dry run) takes token b's choices as experts (b K + k) mod
    E, the same products a token as any choice."""
    if isinstance(eidx, FakeTensor):
        B, K = eidx.shape
        return [[(b * K + k) % E for k in range(K)] for b in range(B)]
    return eidx.tolist()


def _moe_grouped(p: dict, xg: torch.Tensor, cfg: ModelConfig):
    """xg: (G, T, D), G routing groups of T tokens each.

    Sort-based dispatch: each group's T*K (token, choice) slots are sorted
    by expert (a stable sort, so an expert keeps its slots in token order)
    and each expert takes its first C; the slots past C are dropped. The
    combine gathers each token's K expert outputs and adds them in k order
    (the reference scatter-adds them into zeros: for K = 2 the two sums are
    the same bits, and a gather needs no atomics on the card)."""
    probs = moe_probs(xg, p["router"])  # (G, T, E)
    y, counts = moe_dispatch(p, xg, probs, cfg)
    y = coll_out(shard(y, "batch", "seq", "embed"))
    return y, moe_aux(probs, counts, cfg)


def moe_aux(probs: torch.Tensor, counts: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The load-balancing aux loss (Switch/Mixtral formulation), averaged
    over the groups: probs (G, T, E), counts (G, E) of each expert's
    (token, choice) slots."""
    G, T, E = probs.shape
    me = torch.mean(probs, dim=1)  # (G, E)
    assign = counts.to(F32) / (T * cfg.top_k)
    return E * torch.mean(torch.sum(me * assign, dim=-1))


def moe_dispatch(p: dict, xg: torch.Tensor, probs: torch.Tensor, cfg: ModelConfig,
                 experts: Optional[range] = None, capacity_rows: Optional[tuple] = None):
    """``_moe_grouped``'s dispatch, expert products and combine, from the
    router's probs: (y (G, T, D) before its ``shard``, counts (G, E)).
    ``experts``: the expert ids whose weights ``p`` holds (a rank's own
    under expert parallelism), ``p``'s rows in order; only their slots are
    computed and combined (the others' sum is pending on their ranks).
    ``capacity_rows`` (c0, c1): only the capacity rows [c0, c1) of every
    expert are computed and combined (a rank's own when the capacity is
    split across ranks: ``moe_cshard``); counts are every slot's."""
    G, T, D = xg.shape
    dt = xg.dtype
    E, K = cfg.num_experts, cfg.top_k
    C = moe_capacity(T, K, E, cfg.capacity_factor)
    dev = xg.device

    gate, eidx = moe_topk(probs, K)  # (G, T, K)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    flat_e = eidx.reshape(G, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # slot ids sorted by expert
    counts = F.one_hot(flat_e, E).sum(dim=1)  # (G, E)
    starts = torch.cumsum(counts, dim=-1) - counts  # exclusive
    ar = torch.arange(C, device=dev)
    pos = starts[:, :, None] + ar[None, None, :]  # (G, E, C)
    valid = ar[None, None, :] < counts[:, :, None]
    slot = torch.gather(order, 1, torch.clamp(pos, max=T * K - 1).reshape(G, E * C))
    token = slot // K  # (G, E*C)

    xe = torch.gather(xg, 1, token[..., None].expand(G, E * C, D))
    xe = xe.reshape(G, E, C, D) * valid[..., None].to(dt)
    if experts is not None:
        xe = xe[:, experts.start:experts.stop]
    c0, c1 = capacity_rows or (0, C)
    if capacity_rows is not None:
        xe = xe[:, :, c0:c1]
    xe = shard(xe, "batch", "experts", "capacity", "embed")
    h = torch.einsum("gecd,edf->gecf", xe, p["wi"].to(dt))
    g_ = torch.einsum("gecd,edf->gecf", xe, p["wg"].to(dt))
    h = shard(activate(g_, cfg.act) * h, "batch", "experts", "capacity", "moe_ff")
    ye = coll_out(torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt)))
    ye = ye.reshape(G, ye.shape[1] * (c1 - c0), D)

    # combine: slot s = t*K + k sits at rank r of its expert's run in the
    # sorted order; it was kept iff r < C, and its output is row e*C + r
    # (of a rank's own rows [c0, c1): kept iff c0 <= r < c1, row e*(c1-c0) + r-c0)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(T * K, device=dev).expand(G, T * K))
    r = rank - torch.gather(starts, 1, flat_e)
    kept = (r >= c0) & (r < c1)
    e0 = 0
    if experts is not None:
        kept = kept & (flat_e >= experts.start) & (flat_e < experts.stop)
        e0 = experts.start
    row = torch.where(kept, (flat_e - e0) * (c1 - c0) + r - c0, 0)
    w = torch.where(kept, gate.reshape(G, T * K), 0.0).to(dt)
    contrib = torch.gather(ye, 1, row[..., None].expand(G, T * K, D)) * w[..., None]
    contrib = contrib.reshape(G, T, K, D)
    y = contrib[:, :, 0]
    for k in range(1, K):
        y = y + contrib[:, :, k]
    return y, counts

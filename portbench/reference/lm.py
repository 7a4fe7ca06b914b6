"""The plain reference of the decoder configurations (GQA attention with
rotary positions, RMSNorm, a SiLU-gated MLP or a top-k mixture of such
experts), in float32 with plain ``torch`` operations: no kernel, no cache,
no batching across requests. It follows the published ``config.json``
models (Llama-style blocks: rotate-half rotary pairs, ``x * rsqrt(mean(x^2)
+ eps) * w``, GQA head h reading KV head ``h // (heads / kv_heads)``, a
router softmax whose top-k gates are renormalized), with one departure
that the served program makes and the configuration file states
(``assumed.prefill_capacity_factor``): the prompt tokens of a batch row are
routed as one group in which each expert keeps its first C (token, choice)
slots in token order; decode tokens are dropless.

``forward`` runs a whole teacher-forced sequence at once, as the served
program's prefill and decode steps together should: it returns the logits
that predict each token from position P on, the post-rotary K and V of
every layer and position (what a decode cache holds), and the experts each
token chose.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .arch import Arch

F32 = torch.float32


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in full float32 (``tf32=False``) or in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotate_half(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, N, hd) rotated by positions pos (S,): pairs (i, i + hd/2)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32, device=x.device) / hd)
    ang = pos.to(F32)[:, None] * inv[None]  # (S, hd/2)
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(a: Arch, p: dict, h: torch.Tensor, pos: torch.Tensor):
    B, S, _ = h.shape
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    q, k = rotate_half(q, pos, a.rope_theta), rotate_half(k, pos, a.rope_theta)
    group = a.heads // a.kv_heads
    kh = k.repeat_interleave(group, dim=2)  # (B, S, H, hd)
    vh = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kh) / math.sqrt(a.head_dim)
    dist = pos[:, None] - pos[None, :]
    keep = dist >= 0
    if a.sliding_window:
        keep = keep & (dist < a.sliding_window)
    s = s.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vh)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), k, v


def mlp(p: dict, h: torch.Tensor) -> torch.Tensor:
    return (F.silu(h @ p["wg"]) * (h @ p["wi"])) @ p["wo"]


def moe_capacity(tokens: int, k: int, experts: int, factor: float) -> int:
    c = int(math.ceil(tokens * k * factor / experts))
    return max(8, -(-c // 8) * 8)


def moe(a: Arch, p: dict, h: torch.Tensor, prompt: int):
    """Top-k experts of each token; returns (y, chosen experts (B, S, k), the
    router's margin between its k-th and (k+1)-th probability (B, S))."""
    B, S, D = h.shape
    probs = torch.softmax(h @ p["router"], -1)  # (B, S, E)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    margin = gate[..., a.top_k - 1] - gate[..., a.top_k]
    gate, idx = gate[..., : a.top_k], idx[..., : a.top_k]
    gate = gate / gate.sum(-1, keepdim=True)
    kept = torch.ones_like(idx, dtype=torch.bool)
    if prompt:
        cap = moe_capacity(prompt, a.top_k, a.experts, a.prefill_capacity_factor)
        for b in range(B):
            flat = idx[b, :prompt].reshape(-1)  # slot t * k + j, in token order
            rank = torch.empty_like(flat)  # a slot's place among its expert's slots
            for e in range(a.experts):
                mine = flat == e
                rank[mine] = torch.arange(int(mine.sum()), device=h.device)
            kept[b, :prompt] = (rank < cap).reshape(prompt, a.top_k)
    y = torch.zeros_like(h)
    for e in range(a.experts):
        sel = (idx == e) & kept  # (B, S, k)
        if not bool(sel.any()):
            continue
        b, s, j = sel.nonzero(as_tuple=True)
        x = h[b, s]
        out = (F.silu(x @ p["wg"][e]) * (x @ p["wi"][e])) @ p["wo"][e]
        y.index_put_((b, s), out * gate[b, s, j][:, None], accumulate=True)
    return y, idx, margin


def layer_params(w: dict, i: int) -> dict:
    blk = w["blocks"]["sub0"]
    ffn = blk["moe"] if "moe" in blk else blk["mlp"]
    return {"ln1": blk["ln1"][i], "ln2": blk["ln2"][i],
            "attn": {n: t[i] for n, t in blk["attn"].items()},
            "ffn": {n: t[i] for n, t in ffn.items()}}


def supported(a: Arch) -> Arch:
    """``a`` where this reference computes it: rotate-half rotary pairs and
    no projection biases; another layout brings a reference of its own."""
    if a.rope_interleaved or a.qkv_bias:
        raise ValueError("this reference computes rotate-half rotary pairs without "
                         "query, key or value biases")
    return a


def leaf_specs(a: Arch) -> list[tuple[tuple, tuple, str, int]]:
    """(path, shape, init, fan_in) of every leaf, paths in sorted order: the
    program's params tree of this layout."""
    supported(a)
    L, D, H, K, hd, F, V = a.layers, a.d_model, a.heads, a.kv_heads, a.head_dim, a.d_ff, a.vocab
    out = [
        (("embed",), (V, D), "normal", D),
        (("blocks", "sub0", "attn", "wk"), (L, D, K, hd), "normal", D),
        (("blocks", "sub0", "attn", "wo"), (L, H, hd, D), "normal", H * hd),
        (("blocks", "sub0", "attn", "wq"), (L, D, H, hd), "normal", D),
        (("blocks", "sub0", "attn", "wv"), (L, D, K, hd), "normal", D),
        (("blocks", "sub0", "ln1"), (L, D), "ones", 0),
        (("blocks", "sub0", "ln2"), (L, D), "ones", 0),
    ]
    if a.is_moe:
        E = a.experts
        out += [
            (("blocks", "sub0", "moe", "router"), (L, D, E), "normal", D),
            (("blocks", "sub0", "moe", "wg"), (L, E, D, F), "normal", D),
            (("blocks", "sub0", "moe", "wi"), (L, E, D, F), "normal", D),
            (("blocks", "sub0", "moe", "wo"), (L, E, F, D), "normal", F),
        ]
    else:
        out += [
            (("blocks", "sub0", "mlp", "wg"), (L, D, F), "normal", D),
            (("blocks", "sub0", "mlp", "wi"), (L, D, F), "normal", D),
            (("blocks", "sub0", "mlp", "wo"), (L, F, D), "normal", F),
        ]
    out += [
        (("final_norm",), (D,), "ones", 0),
        (("lm_head",), (D, V), "normal", D),
    ]
    return sorted(out)


@torch.no_grad()
def forward(a: Arch, w: dict, tokens: torch.Tensor, prompt: int) -> dict:
    """tokens (B, S): a prompt of ``prompt`` tokens and the served tokens
    fed after it. Returns ``logits`` (B, S - prompt + 1, V) predicting
    tokens[prompt:] and the next one, ``k`` / ``v`` (L, B, S, K, hd) and
    ``experts`` (L, B, S, top_k) and the router's ``margin`` (L, B, S), or
    None."""
    supported(a)
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = w["embed"][tokens]
    ks, vs, chosen, margins = [], [], [], []
    for i in range(a.layers):
        p = layer_params(w, i)
        att, k, v = attention(a, p["attn"], rms_norm(x, p["ln1"], a.norm_eps), pos)
        ks.append(k)
        vs.append(v)
        x = x + att
        h = rms_norm(x, p["ln2"], a.norm_eps)
        if a.is_moe:
            f, idx, margin = moe(a, p["ffn"], h, prompt)
            chosen.append(idx)
            margins.append(margin)
        else:
            f = mlp(p["ffn"], h)
        x = x + f
    x = rms_norm(x[:, prompt - 1:], w["final_norm"], a.norm_eps)
    return {"logits": x @ w["lm_head"], "k": torch.stack(ks), "v": torch.stack(vs),
            "experts": torch.stack(chosen) if chosen else None,
            "margin": torch.stack(margins) if margins else None}

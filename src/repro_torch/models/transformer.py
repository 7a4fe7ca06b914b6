"""Decoder-only LM for the dense archs, on torch tensors.

Depth is ``n_super`` super-layers of ``period`` sublayers, as in the JAX
package; a Python loop over the stacked layer axis takes the place of
``lax.scan``. Uniform archs have period 1; gemma2's local/global
alternation gives period 2. Mamba mixers, MoE FFNs and the encoder-decoder
stack are not ported yet: their configs raise ``NotImplementedError``.

Cache layout (decode-ready), leaf for leaf the JAX package's:
  {"lengths": (B,) int32,
   "blocks": {"sub<i>": {"attn": {"k", "v": (n_super,B,Smax,K,hd),
                                  "pos_ids": (n_super,B,Smax) int32}}}}
``decode_step`` writes the new token into that cache in place and returns
it with ``lengths`` advanced.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .config import ModelConfig
from .layers import SDPA_IMPL, attention, attn_decl, mlp_apply, mlp_decl, rms_norm, softcap
from .params import ParamDecl, init_tree, stacked

F32 = torch.float32


def default_impl(device) -> str:
    """The kernels on a CUDA device, the plain oracle elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def _layer(tree: dict, i: int) -> dict:
    """Slice index ``i`` of the leading (layer) axis of every leaf."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class LM:
    """Decoder-only language model (dense archs)."""

    def __init__(self, cfg: ModelConfig, impl: Optional[str] = None,
                 device="cuda", kv_quant: bool = False):
        if kv_quant:
            raise NotImplementedError("the int8 KV cache (kv_quant) is not ported")
        if cfg.is_moe:
            raise NotImplementedError(f"{cfg.name}: MoE FFNs are not ported")
        if cfg.is_hybrid or cfg.family == "ssm":
            raise NotImplementedError(f"{cfg.name}: mamba mixers are not ported")
        if cfg.is_encoder_decoder:
            raise NotImplementedError(f"{cfg.name}: encoder-decoder is not ported")
        # registers the "cuda" SDPA impl; imported here because the kernel
        # modules import models.layers, which imports this package
        from ..kernels import ops  # noqa: F401

        self.cfg = cfg
        self.device = torch.device(device)
        self.impl = impl if impl is not None else default_impl(self.device)
        if self.impl not in SDPA_IMPL:
            raise KeyError(f"unknown sdpa impl {self.impl!r}; known: {sorted(SDPA_IMPL)}")
        self.period = len(cfg.local_global_pattern) if cfg.local_global_pattern else 1
        if cfg.num_layers % self.period:
            raise ValueError(f"{cfg.num_layers} layers vs period {self.period}")
        self.n_super = cfg.num_layers // self.period
        self.windows = cfg.window_pattern()[: self.period]
        self.has_ffn = cfg.d_ff > 0

    # ------------------------------------------------------------------
    # Declarations
    # ------------------------------------------------------------------
    def _sub_decl(self) -> dict:
        cfg = self.cfg
        d = {"ln1": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
             "attn": attn_decl(cfg)}
        if cfg.post_block_norms:
            d["ln1p"] = ParamDecl((cfg.d_model,), ("embed",), init="ones")
        if self.has_ffn:
            d["ln2"] = ParamDecl((cfg.d_model,), ("embed",), init="ones")
            d["mlp"] = mlp_decl(cfg)
            if cfg.post_block_norms:
                d["ln2p"] = ParamDecl((cfg.d_model,), ("embed",), init="ones")
        return d

    def decls(self) -> dict:
        cfg = self.cfg
        per = {f"sub{i}": self._sub_decl() for i in range(self.period)}
        tree = {
            "embed": ParamDecl(
                (cfg.vocab_size, cfg.d_model), ("vocab", "fsdp"), fan_in=cfg.d_model
            ),
            "blocks": stacked(per, self.n_super),
            "final_norm": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = ParamDecl(
                (cfg.d_model, cfg.vocab_size), ("fsdp", "vocab"), fan_in=cfg.d_model
            )
        return tree

    def init(self, gen: torch.Generator, dtype=F32) -> dict:
        """Random params drawn from ``gen``, a generator on this model's
        device."""
        return init_tree(gen, self.decls(), dtype, self.device)

    # ------------------------------------------------------------------
    # Sublayer body and layer loop
    # ------------------------------------------------------------------
    def _sub_apply(self, p, i, x, *, positions, cache, lengths, want_cache):
        cfg = self.cfg
        h = rms_norm(p["ln1"], x, cfg.norm_eps)
        if cache is not None:
            c_in = cache["attn"]
        elif want_cache:
            c_in = {}
        else:
            c_in = None
        mix, nc = attention(
            p["attn"], h, cfg=cfg, positions=positions, window=self.windows[i],
            cache=c_in, lengths=lengths, impl=self.impl,
        )
        new_cache = {"attn": nc} if nc is not None else {}
        if cfg.post_block_norms:
            mix = rms_norm(p["ln1p"], mix, cfg.norm_eps)
        x = x + mix
        if self.has_ffn:
            h = rms_norm(p["ln2"], x, cfg.norm_eps)
            f = mlp_apply(p["mlp"], h, cfg)
            if cfg.post_block_norms:
                f = rms_norm(p["ln2p"], f, cfg.norm_eps)
            x = x + f
        return x, new_cache

    def _run_blocks(self, params, x, *, positions, cache=None, lengths=None,
                    want_cache=False):
        """Every layer in order. Returns (x, per-layer caches as a list of
        {"sub<i>": ...} dicts, one per super-layer)."""
        caches = []
        for layer in range(self.n_super):
            p_super = _layer(params["blocks"], layer)
            c_super = _layer(cache, layer) if cache is not None else None
            out = {}
            for i in range(self.period):
                sub_cache = c_super[f"sub{i}"] if c_super is not None else None
                x, nc = self._sub_apply(
                    p_super[f"sub{i}"], i, x, positions=positions,
                    cache=sub_cache, lengths=lengths, want_cache=want_cache,
                )
                out[f"sub{i}"] = nc
            caches.append(out)
        return x, caches

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def embed(self, params, tokens, dtype=torch.bfloat16):
        cfg = self.cfg
        x = params["embed"][tokens].to(dtype)
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype, device=x.device)
        return x

    def head(self, params, x) -> torch.Tensor:
        """Logits in float32."""
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = torch.einsum("bsd,dv->bsv", x.to(F32), w.to(x.dtype).to(F32))
        return softcap(logits, cfg.final_logit_softcap)

    def _positions(self, B, S, device, start=None):
        ar = torch.arange(S, dtype=torch.int32, device=device)[None]
        if start is None:
            return ar.expand(B, S)
        return start[:, None] + ar

    # ------------------------------------------------------------------
    # Public steps
    # ------------------------------------------------------------------
    def forward(self, params, tokens, *, dtype=torch.bfloat16):
        """Teacher-forced forward; returns logits (B, S, V) float32."""
        return self.head(params, self.hidden(params, tokens, dtype=dtype))

    def hidden(self, params, tokens, *, dtype=torch.bfloat16):
        """Embed -> blocks -> final norm."""
        x = self.embed(params, tokens, dtype)
        positions = self._positions(x.shape[0], x.shape[1], x.device)
        x, _ = self._run_blocks(params, x, positions=positions)
        return rms_norm(params["final_norm"], x, self.cfg.norm_eps)

    # --- serving ---
    def _attn_cache_len(self, kv_len: int, window: Optional[int]) -> int:
        if window and 0 < window <= kv_len:
            return window  # ring buffer
        return kv_len + 128  # headroom so full-attn decode never wraps

    def cache_spec(self, batch: int, kv_len: int, dtype=torch.bfloat16) -> dict:
        """(shape, dtype) for every leaf of a decode-ready cache at kv_len."""
        K, hd = self.cfg.num_kv_heads, self.cfg.head_dim
        n = self.n_super
        blocks = {}
        for i in range(self.period):
            smax = self._attn_cache_len(kv_len, self.windows[i])
            blocks[f"sub{i}"] = {"attn": {
                "k": ((n, batch, smax, K, hd), dtype),
                "v": ((n, batch, smax, K, hd), dtype),
                "pos_ids": ((n, batch, smax), torch.int32),
            }}
        return {"lengths": ((batch,), torch.int32), "blocks": blocks}

    def init_cache(self, batch: int, kv_len: int, dtype=torch.bfloat16) -> dict:
        """Empty cache: zero K/V, pos_ids -1 (empty slot), lengths 0."""

        def make(spec):
            if isinstance(spec, dict):
                return {k: make(v) for k, v in spec.items()}
            shape, dt = spec
            if dt == torch.int32:
                return torch.full(shape, -1, dtype=dt, device=self.device)
            return torch.zeros(shape, dtype=dt, device=self.device)

        cache = make(self.cache_spec(batch, kv_len, dtype))
        cache["lengths"] = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        return cache

    def prefill(self, params, tokens, *, kv_len: Optional[int] = None,
                dtype=torch.bfloat16):
        """Process a full prompt; returns (last_logits, decode-ready cache)."""
        x = self.embed(params, tokens, dtype)
        B, S = x.shape[:2]
        kv_len = kv_len or S
        positions = self._positions(B, S, x.device)
        x, caches = self._run_blocks(params, x, positions=positions, want_cache=True)
        x = rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self.head(params, x[:, -1:, :])[:, 0]
        return logits, self._finalize_prefill_cache(caches, B, S, kv_len)

    def _finalize_prefill_cache(self, caches, B, S, kv_len):
        """Pad/ring-place prefill K/V into the decode-cache layout."""
        blocks = {}
        for i in range(self.period):
            smax = self._attn_cache_len(kv_len, self.windows[i])
            sub = {}
            for name in ("k", "v", "pos_ids"):
                leaf = torch.stack([c[f"sub{i}"]["attn"][name] for c in caches])
                fill = -1 if name == "pos_ids" else 0
                out = torch.full(leaf.shape[:2] + (smax,) + leaf.shape[3:], fill,
                                 dtype=leaf.dtype, device=leaf.device)
                if smax >= S:
                    out[:, :, :S] = leaf
                else:
                    # ring: contiguous prefill keeps the last smax positions
                    # at slots p % smax
                    idx = torch.arange(S - smax, S, device=leaf.device) % smax
                    out[:, :, idx] = leaf[:, :, S - smax:]
                sub[name] = out
            blocks[f"sub{i}"] = {"attn": sub}
        lengths = torch.full((B,), S, dtype=torch.int32, device=out.device)
        return {"lengths": lengths, "blocks": blocks}

    def decode_step(self, params, cache, tokens, dtype=torch.bfloat16):
        """One decode step for every sequence. tokens: (B, S_new).

        Writes the new K/V into ``cache`` in place. Returns (logits (B, V)
        for the last position, the cache with ``lengths`` advanced)."""
        lengths = cache["lengths"]
        x = self.embed(params, tokens, dtype)
        positions = self._positions(x.shape[0], tokens.shape[1], x.device, start=lengths)
        x, _ = self._run_blocks(params, x, positions=positions,
                                cache=cache["blocks"], lengths=lengths)
        x = rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self.head(params, x)[:, -1]
        return logits, {"lengths": lengths + tokens.shape[1], "blocks": cache["blocks"]}

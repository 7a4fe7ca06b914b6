"""Decoder-only LM for the dense archs, the MoE archs and mamba2, on torch
tensors.

Depth is ``n_super`` super-layers of ``period`` sublayers, as in the JAX
package; a Python loop over the stacked layer axis takes the place of
``lax.scan``. Uniform archs have period 1; gemma2's local/global
alternation gives period 2. Each sublayer's mixer is attention or a mamba2
mixer by ``cfg.layer_kinds()``, and its FFN an MLP or a MoE by
``cfg.ffn_kinds()``; the MoE router's aux loss is summed over every layer.
The jamba hybrid period and the encoder-decoder stack are not ported yet:
their configs raise ``NotImplementedError``.

Training: ``loss`` is the mean next-token cross-entropy, with the LM head
and CE taken in checkpointed sequence chunks above 1,024 tokens
(``chunked_ce``); ``remat="full"`` recomputes each super-layer in the
backward pass.

Cache layout (decode-ready), leaf for leaf the JAX package's:
  {"lengths": (B,) int32,
   "blocks": {"sub<i>": {"attn": {"k", "v": (n_super,B,Smax,K,hd),
                                  "pos_ids": (n_super,B,Smax) int32}}
                      or {"mamba": {"ssm": (n_super,B,H,P,N) float32,
                                    "conv": (n_super,B,W-1,conv_ch)}}}}
``decode_step`` writes the new token's K/V, or the new SSM and conv state,
into that cache in place and returns it with ``lengths`` advanced.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import (SDPA_IMPL, attention, attn_decl, mlp_apply, mlp_decl, moe_apply, moe_decl,
                     rms_norm, softcap)
from .params import ParamDecl, init_tree, stacked, tree_map
from .ssd import SSD_IMPL, mamba_apply, mamba_cache_decl, mamba_decl

F32 = torch.float32


def _ce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logsumexp - gold logit at each position; logits (B,S,V) float32."""
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; logits (B,S,V) float32, targets (B,S)."""
    return torch.mean(_ce_terms(logits, targets))


#: sequence-chunk the LM head + CE when S exceeds twice this: the full
#: (B,S,V) logits tensor (and its gradient) never materializes.
_CE_CHUNK = 512


def _chunk_ce_sum(head_fn, xc, tc):
    return torch.sum(_ce_terms(head_fn(xc), tc))


def chunked_ce(head_fn, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """CE over head_fn(x-chunk) with each chunk recomputed in the backward
    pass (``torch.utils.checkpoint`` in place of ``jax.checkpoint``).
    x: (B,S,D)."""
    B, S, D = x.shape
    if S <= 2 * _CE_CHUNK:
        return ce_loss(head_fn(x), targets)
    c = _CE_CHUNK
    while S % c:
        c //= 2
    acc = torch.zeros((), dtype=F32, device=x.device)
    for i in range(0, S, c):
        acc = acc + checkpoint(_chunk_ce_sum, head_fn, x[:, i:i + c], targets[:, i:i + c],
                               use_reentrant=False)
    return acc / (B * S)


def _mm_f32(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(c +) a @ b of two bf16 matrices, summed and returned in float32: on the
    card one bf16 tensor-core GEMM with float32 output (``aten::mm.dtype``,
    ``aten::addmm.dtype`` with c in its epilogue); elsewhere the same
    products in float32 (each exact: a product of two bf16 values fits a
    float32)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=F32) if c is None else torch.addmm(c, a, b, out_dtype=F32)
    ab = torch.mm(a.to(F32), b.to(F32))
    return ab if c is None else c + ab


class HeadLogits(torch.autograd.Function):
    """logits = x w in float32 from bf16 x (..., D) and bf16 w (D, V): the
    reference's ``einsum(x, w.astype(bf16), preferred_element_type=F32)``,
    on the tensor cores. The backward keeps the reference's rounding points
    (its dot_general transposes): dx = bf16(g wᵀ) and dw = bf16(xᵀ g), with
    the products summed in float32. g is float32, so it is split into two
    bf16 halves, g = hi + lo to ~2^-16 of g, and each gradient is the sum of
    two bf16 products, lo's and then hi's, the second GEMM adding the
    first's float32 result in its epilogue."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        hi = g.to(x.dtype)
        lo = (g - hi).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(hi, w.T, _mm_f32(lo, w.T)).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            x2 = x.reshape(-1, x.shape[-1])
            if w.T.is_contiguous():  # the tied embedding, (V, D) in memory: dw in its layout
                dw = _mm_f32(hi.T, x2, _mm_f32(lo.T, x2)).T
            else:
                dw = _mm_f32(x2.T, hi, _mm_f32(x2.T, lo))
            dw = dw.to(w.dtype)
        return dx, dw


def head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 logits of bf16 x (..., D) against bf16 w (D, V) (``HeadLogits``)."""
    return HeadLogits.apply(x, w)


def plain_head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 logits of x (B, S, D) against w (D, V) rounded to x's type, as
    one float32 product: the plain version of ``head_logits``, and the head of
    float32 x."""
    return torch.einsum("bsd,dv->bsv", x.to(F32), w.to(x.dtype).to(F32))


def default_impl(device) -> str:
    """The kernels on a CUDA device, the plain oracle elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def _layer(tree: dict, i: int) -> dict:
    """Slice index ``i`` of the leading (layer) axis of every leaf."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class LM:
    """Decoder-only language model (dense and MoE archs, and mamba2)."""

    def __init__(self, cfg: ModelConfig, impl: Optional[str] = None,
                 device="cuda", kv_quant: bool = False):
        if kv_quant:
            raise NotImplementedError("the int8 KV cache (kv_quant) is not ported")
        if cfg.is_hybrid:
            raise NotImplementedError(f"{cfg.name}: the hybrid period is not ported")
        if cfg.is_encoder_decoder:
            raise NotImplementedError(f"{cfg.name}: encoder-decoder is not ported")
        # registers the "cuda" SDPA and SSD impls; imported here because the
        # kernel modules import models.layers, which imports this package
        from ..kernels import ops  # noqa: F401

        self.cfg = cfg
        self.device = torch.device(device)
        self.impl = impl if impl is not None else default_impl(self.device)
        for kind, registry in (("sdpa", SDPA_IMPL), ("ssd", SSD_IMPL)):
            if self.impl not in registry:
                raise KeyError(f"unknown {kind} impl {self.impl!r}; known: {sorted(registry)}")
        self.period = len(cfg.local_global_pattern) if cfg.local_global_pattern else 1
        if cfg.num_layers % self.period:
            raise ValueError(f"{cfg.num_layers} layers vs period {self.period}")
        self.n_super = cfg.num_layers // self.period
        self.kinds = cfg.layer_kinds()[: self.period]
        self.ffns = cfg.ffn_kinds()[: self.period]
        self.windows = cfg.window_pattern()[: self.period]
        self.has_ffn = cfg.d_ff > 0

    # ------------------------------------------------------------------
    # Declarations
    # ------------------------------------------------------------------
    def _sub_decl(self, i: int) -> dict:
        cfg = self.cfg
        d = {"ln1": ParamDecl((cfg.d_model,), ("embed",), init="ones")}
        if self.kinds[i] == "attn":
            d["attn"] = attn_decl(cfg)
        else:
            d["mamba"] = mamba_decl(cfg)
        if cfg.post_block_norms:
            d["ln1p"] = ParamDecl((cfg.d_model,), ("embed",), init="ones")
        if self.has_ffn:
            d["ln2"] = ParamDecl((cfg.d_model,), ("embed",), init="ones")
            if self.ffns[i] == "moe":
                d["moe"] = moe_decl(cfg)
            else:
                d["mlp"] = mlp_decl(cfg)
            if cfg.post_block_norms:
                d["ln2p"] = ParamDecl((cfg.d_model,), ("embed",), init="ones")
        return d

    def decls(self) -> dict:
        cfg = self.cfg
        per = {f"sub{i}": self._sub_decl(i) for i in range(self.period)}
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

    def param_shapes(self, dtype=F32) -> dict:
        """Every param as a tensor on the "meta" device: shape and dtype, no
        storage (the counterpart of the reference's ShapeDtypeStructs; the
        checkpoint restore template)."""
        return tree_map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
                        self.decls())

    # ------------------------------------------------------------------
    # Sublayer body and layer loop
    # ------------------------------------------------------------------
    def _sub_apply(self, p, i, x, *, positions, cache, lengths, want_cache):
        """One sublayer; returns (x, its new cache, its MoE aux loss: a
        float 0.0 where its FFN is not a MoE)."""
        cfg = self.cfg
        h = rms_norm(p["ln1"], x, cfg.norm_eps)
        kind = self.kinds[i]
        if kind == "attn":
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
        else:
            c_in = cache["mamba"] if cache is not None else None
            mix, nc = mamba_apply(p["mamba"], h, cfg=cfg, cache=c_in,
                                  want_cache=want_cache, impl=self.impl)
        new_cache = {kind: nc} if nc is not None else {}
        if cfg.post_block_norms:
            mix = rms_norm(p["ln1p"], mix, cfg.norm_eps)
        x = x + mix
        aux = 0.0  # a float, not a tensor: no launch for a layer without a MoE
        if self.has_ffn:
            h = rms_norm(p["ln2"], x, cfg.norm_eps)
            if self.ffns[i] == "moe":
                f, aux = moe_apply(p["moe"], h, cfg)
            else:
                f = mlp_apply(p["mlp"], h, cfg)
            if cfg.post_block_norms:
                f = rms_norm(p["ln2p"], f, cfg.norm_eps)
            x = x + f
        return x, new_cache, aux

    def _super_apply(self, p_super, x, positions):
        """One super-layer without a cache (the body that remat recomputes);
        returns (x, the sum of its sublayers' aux losses)."""
        auxes = []
        for i in range(self.period):
            x, _, aux = self._sub_apply(p_super[f"sub{i}"], i, x, positions=positions,
                                        cache=None, lengths=None, want_cache=False)
            auxes.append(aux)
        return x, sum(auxes)

    def _run_blocks(self, params, x, *, positions, cache=None, lengths=None,
                    want_cache=False, remat=None):
        """Every layer in order. Returns (x, per-layer caches as a list of
        {"sub<i>": ...} dicts, one per super-layer, the MoE aux loss summed
        over every sublayer of every layer).

        ``remat``: None keeps every activation for the backward pass;
        "full" recomputes each super-layer in it (one
        ``torch.utils.checkpoint`` per super-layer, the reference's
        ``jax.checkpoint`` of the scan body). "dots" and "coll" are XLA
        checkpoint policies and raise ``NotImplementedError``."""
        if remat in ("dots", "coll"):
            raise NotImplementedError(
                f"remat={remat!r} is an XLA checkpoint policy, not ported "
                "(ROADMAP queue 1 item 13)")
        if remat not in (None, "full"):
            raise ValueError(f"remat {remat!r} not in (None, 'full', 'dots', 'coll')")
        auxes = []
        if remat == "full":  # the training forward: no cache
            for layer in range(self.n_super):
                x, aux = checkpoint(self._super_apply, _layer(params["blocks"], layer), x,
                                    positions, use_reentrant=False)
                auxes.append(aux)
            return x, [], sum(auxes)
        caches = []
        for layer in range(self.n_super):
            p_super = _layer(params["blocks"], layer)
            c_super = _layer(cache, layer) if cache is not None else None
            out = {}
            for i in range(self.period):
                sub_cache = c_super[f"sub{i}"] if c_super is not None else None
                x, nc, aux = self._sub_apply(
                    p_super[f"sub{i}"], i, x, positions=positions,
                    cache=sub_cache, lengths=lengths, want_cache=want_cache,
                )
                out[f"sub{i}"] = nc
                auxes.append(aux)
            caches.append(out)
        return x, caches, sum(auxes)

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------
    def embed(self, params, tokens, dtype=torch.bfloat16):
        cfg = self.cfg
        x = params["embed"][tokens.long()].to(dtype)
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype, device=x.device)
        return x

    def head(self, params, x) -> torch.Tensor:
        """Logits in float32, from x and the weights in x's type: bf16 x on the
        card takes the bf16 tensor-core GEMM with float32 output
        (``head_logits``); elsewhere, and for float32 x, the same arithmetic
        as a float32 product (``plain_head_logits``)."""
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        if x.is_cuda and x.dtype == torch.bfloat16:
            logits = head_logits(x, w.to(x.dtype))
        else:
            logits = plain_head_logits(x, w)
        return softcap(logits, cfg.final_logit_softcap)

    def _positions(self, B, S, device, start=None):
        ar = torch.arange(S, dtype=torch.int32, device=device)[None]
        if start is None:
            return ar.expand(B, S)
        return start[:, None] + ar

    # ------------------------------------------------------------------
    # Public steps
    # ------------------------------------------------------------------
    def forward(self, params, tokens, *, remat=None, dtype=torch.bfloat16):
        """Teacher-forced forward; returns logits (B, S, V) float32."""
        return self.head(params, self.hidden(params, tokens, remat=remat, dtype=dtype))

    def hidden(self, params, tokens, *, remat=None, dtype=torch.bfloat16):
        """Embed -> blocks -> final norm."""
        return self._hidden_aux(params, tokens, remat=remat, dtype=dtype)[0]

    def _hidden_aux(self, params, tokens, *, remat, dtype):
        """(``hidden``'s x, the MoE aux loss summed over the layers)."""
        x = self.embed(params, tokens, dtype)
        positions = self._positions(x.shape[0], x.shape[1], x.device)
        x, _, aux = self._run_blocks(params, x, positions=positions, remat=remat)
        return rms_norm(params["final_norm"], x, self.cfg.norm_eps), aux

    def loss(self, params, batch, *, remat=None, dtype=torch.bfloat16):
        """batch: tokens (B,S), targets (B,S). Returns (total, {"ce", "aux"}):
        ``aux`` is the MoE router loss summed over the layers (0 without
        MoE FFNs), weighted by ``router_aux_weight`` in the total. A vision
        frontend or an encoder input is refused: the reference prepends the
        patches and drops their positions before the CE, which is not ported."""
        extra = sorted({"patch_embeds", "enc_embeds"} & set(batch))
        if self.cfg.frontend or extra:
            raise NotImplementedError(
                f"{self.cfg.name}: the loss over a frontend ({self.cfg.frontend!r}) or "
                f"encoder inputs {extra} is not ported")
        x, aux = self._hidden_aux(params, batch["tokens"], remat=remat, dtype=dtype)
        aux = torch.as_tensor(aux, dtype=F32, device=x.device)
        ce = chunked_ce(lambda xc: self.head(params, xc), x, batch["targets"])
        return ce + self.cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}

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
            if self.kinds[i] == "attn":
                smax = self._attn_cache_len(kv_len, self.windows[i])
                blocks[f"sub{i}"] = {"attn": {
                    "k": ((n, batch, smax, K, hd), dtype),
                    "v": ((n, batch, smax, K, hd), dtype),
                    "pos_ids": ((n, batch, smax), torch.int32),
                }}
            else:
                blocks[f"sub{i}"] = {"mamba": {
                    name: ((n,) + shape, dt)
                    for name, (shape, dt) in mamba_cache_decl(self.cfg, batch, dtype).items()
                }}
        return {"lengths": ((batch,), torch.int32), "blocks": blocks}

    def init_cache(self, batch: int, kv_len: int, dtype=torch.bfloat16) -> dict:
        """Empty cache: zero K/V and SSM/conv state, pos_ids -1 (empty
        slot), lengths 0."""

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
        x, caches, _ = self._run_blocks(params, x, positions=positions, want_cache=True)
        x = rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self.head(params, x[:, -1:, :])[:, 0]
        return logits, self._finalize_prefill_cache(caches, B, S, kv_len, x.device)

    def _finalize_prefill_cache(self, caches, B, S, kv_len, device):
        """Pad/ring-place prefill K/V into the decode-cache layout; stack the
        mamba state as it is."""
        blocks = {}
        for i in range(self.period):
            if self.kinds[i] == "mamba":
                blocks[f"sub{i}"] = {"mamba": {
                    name: torch.stack([c[f"sub{i}"]["mamba"][name] for c in caches])
                    for name in ("ssm", "conv")
                }}
                continue
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
        lengths = torch.full((B,), S, dtype=torch.int32, device=device)
        return {"lengths": lengths, "blocks": blocks}

    def decode_step(self, params, cache, tokens, dtype=torch.bfloat16):
        """One decode step for every sequence. tokens: (B, S_new).

        Writes the new K/V and mamba state into ``cache`` in place. Returns
        (logits (B, V) for the last position, the cache with ``lengths``
        advanced)."""
        lengths = cache["lengths"]
        x = self.embed(params, tokens, dtype)
        positions = self._positions(x.shape[0], tokens.shape[1], x.device, start=lengths)
        x, _, _ = self._run_blocks(params, x, positions=positions,
                                   cache=cache["blocks"], lengths=lengths)
        x = rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self.head(params, x)[:, -1]
        return logits, {"lengths": lengths + tokens.shape[1], "blocks": cache["blocks"]}

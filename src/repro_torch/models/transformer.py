"""The LM of every arch in the registry, on torch tensors: the dense
decoders, the MoE archs, mamba2, jamba's hybrid, seamless's
encoder-decoder and internvl2's vision-patch frontend.

Depth is ``n_super`` super-layers of ``period`` sublayers, as in the JAX
package; a Python loop over the stacked layer axis takes the place of
``lax.scan``. Uniform archs have period 1; gemma2's local/global
alternation gives period 2; jamba's mamba/attention 7:1 interleave with
alternating dense/MoE FFNs gives period 8. Each sublayer's mixer is
attention or a mamba2 mixer by ``cfg.layer_kinds()``, and its FFN an MLP or
a MoE by ``cfg.ffn_kinds()``; the MoE router's aux loss is summed over the
MoE sublayers. Encoder-decoder (seamless) adds an encoder stack over
precomputed frame embeddings and cross-attention to every decoder
attention sublayer; a vision frontend (internvl2) puts precomputed patch
embeddings before the token embeddings.

Training: ``loss`` is the mean next-token cross-entropy, with the LM head
and CE taken in checkpointed sequence chunks above 1,024 tokens
(``chunked_ce``), over the text positions: a vision frontend's patch
positions are dropped before it, and an encoder-decoder's encoder runs over
the batch's frame embeddings. ``remat`` picks what each super-layer keeps
for the backward pass (``REMAT_POLICIES``): everything (None), nothing
("full"), the products with no batch dimension ("dots") or the tagged
sublayer outputs ("coll").

Cache layout (decode-ready), leaf for leaf the JAX package's:
  {"lengths": (B,) int32,
   "blocks": {"sub<i>": {"attn": {"k", "v": (n_super,B,Smax,K,hd),
                                  "pos_ids": (n_super,B,Smax) int32}}
                      or {"mamba": {"ssm": (n_super,B,H,P,N) float32,
                                    "conv": (n_super,B,W-1,conv_ch)}}},
   "cross": {"sub<i>": {"k", "v": (n_super,B,Se,K,hd),
                        "pos_ids": (n_super,B,Se) int32}}}  (enc-dec only)
With ``kv_quant`` an attention cache holds "k_q", "v_q" (int8) and "k_s",
"v_s" (n_super,B,Smax,K) float32 in place of "k" and "v". ``decode_step``
writes the new token's K/V, or the new SSM and conv state, into that cache
in place and returns it with ``lengths`` advanced; the cross K/V is
read-only.

``param_axes`` and ``cache_axes`` name every leaf's logical axes, the
reference's, from which ``parallel/sharding.py`` places a tree on a mesh;
the embeddings, the encoder's input and the logits pass the reference's
``shard`` sites, as do the layers' activations (``models/layers.py``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from functools import partial
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..parallel import spmd
from ..parallel.sharding import current_ctx, shard, sharding_ctx
from .config import ModelConfig
from .layers import (MOE_IMPL, SDPA_IMPL, attention, attn_decl, mlp_apply, mlp_decl, moe_apply,
                     moe_decl, rms_norm, softcap)
from .params import ParamDecl, init_tree, stacked, tree_map
from .ssd import SSD_IMPL, mamba_apply, mamba_cache_decl, mamba_decl

F32 = torch.float32
_aten = torch.ops.aten
_c10d = torch.ops._c10d_functional


def _dots_saveable(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: save a
    matrix product with no batch dimension, recompute everything else.
    ``torch.einsum`` lowers every two-operand product to ``aten.bmm``, folding
    the equation's batch dimensions into the bmm's batch: the projections
    ("bsd,dhk->bshk", "bshk,hkd->bsd", "bsd,df->bsf") reach it with a batch
    of 1, the attention scores and the experts' products ("bqkgd,bskd->...",
    "gecd,edf->gecf") with B x K and E; ``@`` (the router) reaches
    ``aten.mm``. (An equation whose batch dimensions all have size 1 folds to
    a batch of 1 and is saved too: more memory, the same values.)"""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _AfterAllReduce(threading.local):
    pending = False


_AFTER_ALL_REDUCE = _AfterAllReduce()


def _coll_saveable(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.save_only_these_names("coll_out")``: save
    the outputs tagged by ``layers.coll_out``, recompute everything else.
    On a mesh each tagged output is the result of an all-reduce (``shard``
    of a Partial sum), which the reference's recompute never reissues (the
    saved output makes it dead code): the all-reduce and its wait are saved
    too, so the recompute issues no all-reduce. (The FSDP all-gathers are
    recomputed, as the reference re-gathers a layer's params.)"""
    if op is torch.ops.repro_torch.coll_out.default:
        return CheckpointPolicy.MUST_SAVE
    if op is _c10d.all_reduce.default:
        _AFTER_ALL_REDUCE.pending = True
        return CheckpointPolicy.MUST_SAVE
    if op is _c10d.wait_tensor.default and _AFTER_ALL_REDUCE.pending:
        _AFTER_ALL_REDUCE.pending = False
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _checkpoint_contexts(policy=None):
    """``torch.utils.checkpoint``'s ``context_fn``: the selective policy's
    forward and recompute contexts (none without a policy), the recompute's
    under the sharding context of the forward that made it. The recompute
    runs where the backward pass runs, on the card the autograd engine's
    own thread, whose thread-local context is empty: ``shard`` would pass
    every activation through unconstrained there."""
    mesh, rules = current_ctx()

    def contexts():
        if policy is None:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        else:
            fwd, rec = create_selective_checkpoint_contexts(policy)
        return fwd, _both(rec, _both(sharding_ctx(mesh, rules), spmd.on_mesh_ops()))

    return contexts


#: the remat policies: what a super-layer keeps for the backward pass. None
#: keeps every activation, "full" none (the reference's ``jax.checkpoint``
#: of its scan body), "dots" and "coll" what their policy saves.
REMAT_POLICIES = {None: None, "full": None, "dots": _dots_saveable, "coll": _coll_saveable}


def _ce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logsumexp - gold logit at each position; logits (B,S,V) float32
    (a DTensor's vocab may be split: ``spmd.vocab_ce_terms``)."""
    if spmd.is_dtensor(logits):
        return spmd.vocab_ce_terms(logits, targets)
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
                               use_reentrant=False, context_fn=_checkpoint_contexts())
    return acc / (B * S)


def card_route(t) -> bool:
    """Whether ``t`` takes the card's routes: a tensor on a CUDA device, or a
    FakeTensor of any device (a step traced by the production dry run, which
    counts what the card would do)."""
    loc = t.to_local() if spmd.is_dtensor(t) else t
    return loc.is_cuda or isinstance(loc, FakeTensor)


def _mm_f32(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(c +) a @ b of two bf16 matrices, summed and returned in float32: on the
    card one bf16 tensor-core GEMM with float32 output (``aten::mm.dtype``,
    ``aten::addmm.dtype`` with c in its epilogue); elsewhere the same
    products in float32 (each exact: a product of two bf16 values fits a
    float32)."""
    if card_route(a):
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
    return spmd.einsum("bsd,dv->bsv", x.to(F32), w.to(x.dtype).to(F32))


def default_impl(device) -> str:
    """The kernels on a CUDA device, the plain oracle elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def _slots(leaf: torch.Tensor, *, smax: int, S: int, fill: int) -> torch.Tensor:
    """A stacked prefill K/V leaf (n, B, S, ...) in a decode cache of
    ``smax`` slots: padded with ``fill``, or ring-placed."""
    out = torch.full(leaf.shape[:2] + (smax,) + leaf.shape[3:], fill,
                     dtype=leaf.dtype, device=leaf.device)
    if smax >= S:
        out[:, :, :S] = leaf
    else:
        # ring: contiguous prefill keeps the last smax positions at slots p % smax
        idx = torch.arange(S - smax, S, device=leaf.device) % smax
        out[:, :, idx] = leaf[:, :, S - smax:]
    return out


def _layer(tree: dict, i: int) -> dict:
    """Slice index ``i`` of the leading (layer) axis of every leaf."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class LM:
    """Decoder-only / hybrid / encoder-decoder language model."""

    def __init__(self, cfg: ModelConfig, impl: Optional[str] = None,
                 device="cuda", kv_quant: bool = False):
        # registers the "cuda" SDPA, SSD and MoE impls; imported here because the
        # kernel modules import models.layers, which imports this package
        from ..kernels import ops  # noqa: F401

        self.cfg = cfg
        self.device = torch.device(device)
        self.kv_quant = kv_quant  # int8 KV cache (serving)
        self.impl = impl if impl is not None else default_impl(self.device)
        for kind, registry in (("sdpa", SDPA_IMPL), ("ssd", SSD_IMPL), ("moe", MOE_IMPL)):
            if self.impl not in registry:
                raise KeyError(f"unknown {kind} impl {self.impl!r}; known: {sorted(registry)}")
        if cfg.is_hybrid:
            self.period = cfg.hybrid_period
        elif cfg.local_global_pattern:
            self.period = len(cfg.local_global_pattern)
        else:
            self.period = 1
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
        if cfg.is_encoder_decoder and self.kinds[i] == "attn":
            d["ln_x"] = ParamDecl((cfg.d_model,), ("embed",), init="ones")
            d["cross"] = attn_decl(cfg, cross=True)
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
        if cfg.is_encoder_decoder:
            enc_sub = {
                "ln1": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
                "attn": attn_decl(cfg),
                "ln2": ParamDecl((cfg.d_model,), ("embed",), init="ones"),
                "mlp": mlp_decl(cfg),
            }
            tree["enc_blocks"] = stacked({"sub0": enc_sub}, cfg.num_encoder_layers)
            tree["enc_final_norm"] = ParamDecl((cfg.d_model,), ("embed",), init="ones")
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

    def param_axes(self) -> dict:
        """Every param's logical axis names (``ParamDecl.axes``), in the tree
        of ``param_shapes``."""
        return tree_map(lambda d: d.axes, self.decls())

    # ------------------------------------------------------------------
    # Sublayer body and layer loop
    # ------------------------------------------------------------------
    def _sub_apply(self, p, i, x, *, positions, cache, lengths, want_cache,
                   enc_out=None, cross_kv=None):
        """One sublayer; returns (x, its new cache, its MoE aux loss: a
        float 0.0 where its FFN is not a MoE). An encoder-decoder attention
        sublayer then cross-attends: in prefill (and the teacher-forced
        forward) to K/V projected from ``enc_out`` at positions arange(Se),
        kept as the new cache's "cross" when one is wanted; in decode to the
        read-only ``cross_kv``."""
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
                cache=c_in, lengths=lengths, impl=self.impl, kv_quant=self.kv_quant,
            )
        else:
            c_in = cache["mamba"] if cache is not None else None
            mix, nc = mamba_apply(p["mamba"], h, cfg=cfg, cache=c_in,
                                  want_cache=want_cache, impl=self.impl)
        new_cache = {kind: nc} if nc is not None else {}
        if cfg.post_block_norms:
            mix = rms_norm(p["ln1p"], mix, cfg.norm_eps)
        x = x + mix

        if "cross" in p and (enc_out is not None or cross_kv is not None):
            h = rms_norm(p["ln_x"], x, cfg.norm_eps)
            if cross_kv is not None:
                kv = (cross_kv["k"], cross_kv["v"], cross_kv["pos_ids"])
            else:
                dt = h.dtype
                ek = torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wk"].to(dt))
                ev = torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wv"].to(dt))
                epos = self._positions(enc_out.shape[0], enc_out.shape[1], enc_out.device)
                if want_cache:
                    new_cache["cross"] = {"k": ek, "v": ev, "pos_ids": epos}
                kv = (ek, ev, epos)
            cx, _ = attention(p["cross"], h, cfg=cfg, positions=positions, kv_override=kv,
                              causal=False, use_rope=False, impl=self.impl)
            x = x + cx

        aux = 0.0  # a float, not a tensor: no launch for a layer without a MoE
        if self.has_ffn:
            h = rms_norm(p["ln2"], x, cfg.norm_eps)
            if self.ffns[i] == "moe":
                f, aux = moe_apply(p["moe"], h, cfg, self.impl)
            else:
                f = mlp_apply(p["mlp"], h, cfg)
            if cfg.post_block_norms:
                f = rms_norm(p["ln2p"], f, cfg.norm_eps)
            x = x + f
        return x, new_cache, aux

    def _super_apply(self, p_super, x, positions, enc_out=None):
        """One super-layer without a cache (the body that remat recomputes);
        returns (x, the sum of its sublayers' aux losses)."""
        auxes = []
        if spmd.is_dtensor(x):
            p_super = spmd.gather_for_use(p_super, x.dtype)
        for i in range(self.period):
            x, _, aux = self._sub_apply(p_super[f"sub{i}"], i, x, positions=positions,
                                        cache=None, lengths=None, want_cache=False,
                                        enc_out=enc_out)
            auxes.append(aux)
        return x, sum(auxes)

    def _run_blocks(self, params, x, *, positions, cache=None, cross=None, lengths=None,
                    want_cache=False, enc_out=None, remat=None):
        """Every layer in order. Returns (x, per-layer caches as a list of
        {"sub<i>": ...} dicts, one per super-layer, the MoE aux loss summed
        over every sublayer of every layer). ``cross`` is the stacked
        read-only cross K/V of a decode step; ``enc_out`` the encoder's
        output in prefill and the teacher-forced forward.

        ``remat``: None keeps every activation for the backward pass;
        "full", "dots" and "coll" run each super-layer under one
        ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
        scan body): "full" recomputes all of it in the backward pass, "dots"
        and "coll" keep what their policy saves (``REMAT_POLICIES``, a
        selective-checkpoint context) and recompute the rest."""
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat {remat!r} not in {tuple(REMAT_POLICIES)}")
        auxes = []
        if remat is not None:  # the training forward: no cache
            contexts = _checkpoint_contexts(REMAT_POLICIES[remat])
            for layer in range(self.n_super):
                x, aux = checkpoint(self._super_apply, _layer(params["blocks"], layer), x,
                                    positions, enc_out, use_reentrant=False,
                                    context_fn=contexts)
                auxes.append(aux)
            return x, [], sum(auxes)
        caches = []
        for layer in range(self.n_super):
            p_super = _layer(params["blocks"], layer)
            c_super = _layer(cache, layer) if cache is not None else None
            x_super = _layer(cross, layer) if cross is not None else {}
            out = {}
            for i in range(self.period):
                sub_cache = c_super[f"sub{i}"] if c_super is not None else None
                p_sub = p_super[f"sub{i}"]
                if spmd.is_dtensor(x):  # FSDP: this sublayer's params, gathered for use
                    p_sub = spmd.gather_for_use(p_sub, x.dtype)
                x, nc, aux = self._sub_apply(
                    p_sub, i, x, positions=positions,
                    cache=sub_cache, lengths=lengths, want_cache=want_cache,
                    enc_out=enc_out, cross_kv=x_super.get(f"sub{i}"),
                )
                out[f"sub{i}"] = nc
                auxes.append(aux)
            caches.append(out)
        return x, caches, sum(auxes)

    # ------------------------------------------------------------------
    # Embedding / head / encoder
    # ------------------------------------------------------------------
    def embed(self, params, tokens, frontend_embeds=None, dtype=torch.bfloat16):
        """Token embeddings (B, S, D) in ``dtype``; precomputed frontend
        embeddings (B, F, D), where given, go before them (B, F + S, D)."""
        cfg = self.cfg
        table = params["embed"]
        if spmd.is_dtensor(table):
            table = spmd.gather_for_use({"embed": table}, dtype)["embed"]
            x = spmd.embed_lookup(table, tokens).to(dtype)
        else:
            x = table[tokens.long()].to(dtype)
        if cfg.scale_embeddings:
            # a fill, not a copy from the host: a captured step holds it
            x = x * torch.full((), math.sqrt(cfg.d_model), dtype=dtype, device=x.device)
        if frontend_embeds is not None:
            x = torch.cat([frontend_embeds.to(dtype), x], dim=1)
        return shard(x, "batch", "seq", "embed")

    def head(self, params, x) -> torch.Tensor:
        """Logits in float32, from x and the weights in x's type: bf16 x on the
        card (``card_route``) takes the bf16 tensor-core GEMM with float32
        output (``head_logits``); elsewhere, and for float32 x, the same
        arithmetic as a float32 product (``plain_head_logits``)."""
        cfg = self.cfg
        name = "embed" if cfg.tie_embeddings else "lm_head"
        w = params[name]
        if spmd.is_dtensor(w):
            w = spmd.gather_for_use({name: w}, x.dtype)[name]
        w = w.T if cfg.tie_embeddings else w
        if x.dtype == torch.bfloat16 and card_route(x):
            logits = spmd.einsum("bsd,dv->bsv", x, w.to(x.dtype), fn=head_logits)
        else:
            logits = plain_head_logits(x, w)
        return shard(softcap(logits, cfg.final_logit_softcap), "batch", "seq", "vocab")

    def encode(self, params, enc_embeds, remat=None):
        """The encoder stack over precomputed frame embeddings (B, Se, D),
        in their type (the audio frontend is a stub, as in the reference):
        non-causal self-attention with rope at positions arange(Se), then a
        gated MLP, each layer. Under any remat policy each layer is
        recomputed whole in the backward pass, as the reference checkpoints
        its encoder whenever ``remat`` is set."""
        cfg = self.cfg
        x = shard(enc_embeds, "batch", "seq", "embed")
        positions = self._positions(x.shape[0], x.shape[1], x.device)

        def body(p, h):
            a = rms_norm(p["ln1"], h, cfg.norm_eps)
            mix, _ = attention(p["attn"], a, cfg=cfg, positions=positions, causal=False,
                               impl=self.impl)
            h = h + mix
            return h + mlp_apply(p["mlp"], rms_norm(p["ln2"], h, cfg.norm_eps), cfg)

        for layer in range(cfg.num_encoder_layers):
            p = _layer(params["enc_blocks"], layer)["sub0"]
            x = (checkpoint(body, p, x, use_reentrant=False, context_fn=_checkpoint_contexts())
                 if remat else body(p, x))
        return rms_norm(params["enc_final_norm"], x, cfg.norm_eps)

    def _encoder_out(self, params, enc_embeds, dtype, remat=None):
        """The encoder's output for an encoder-decoder arch (which requires
        ``enc_embeds``), else None."""
        if not self.cfg.is_encoder_decoder:
            return None
        if enc_embeds is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder model requires enc_embeds")
        return self.encode(params, enc_embeds.to(dtype), remat=remat)

    def _positions(self, B, S, device, start=None):
        ar = torch.arange(S, dtype=torch.int32, device=device)[None]
        if start is None:
            return ar.expand(B, S)
        return start[:, None] + ar

    # ------------------------------------------------------------------
    # Public steps
    # ------------------------------------------------------------------
    def forward(self, params, tokens, *, frontend_embeds=None, enc_embeds=None, remat=None,
                dtype=torch.bfloat16):
        """Teacher-forced forward; returns logits (B, F + S, V) float32 (F
        frontend positions, where given)."""
        return self.head(params, self.hidden(params, tokens, frontend_embeds=frontend_embeds,
                                             enc_embeds=enc_embeds, remat=remat, dtype=dtype))

    def hidden(self, params, tokens, *, frontend_embeds=None, enc_embeds=None, remat=None,
               dtype=torch.bfloat16):
        """Embed -> blocks -> final norm."""
        return self._hidden_aux(params, tokens, frontend_embeds=frontend_embeds,
                                enc_embeds=enc_embeds, remat=remat, dtype=dtype)[0]

    def _hidden_aux(self, params, tokens, *, remat, dtype, frontend_embeds=None,
                    enc_embeds=None):
        """(``hidden``'s x, the MoE aux loss summed over the layers)."""
        x = self.embed(params, tokens, frontend_embeds, dtype)
        positions = self._positions(x.shape[0], x.shape[1], x.device)
        enc_out = self._encoder_out(params, enc_embeds, dtype, remat)
        x, _, aux = self._run_blocks(params, x, positions=positions, enc_out=enc_out,
                                     remat=remat)
        return rms_norm(params["final_norm"], x, self.cfg.norm_eps), aux

    def loss(self, params, batch, *, remat=None, dtype=torch.bfloat16):
        """batch: tokens (B,S), targets (B,S), and ``patch_embeds`` (B,F,D)
        for a vision frontend or ``enc_embeds`` (B,Se,D) for an
        encoder-decoder. Returns (total, {"ce", "aux"}): the CE over the text
        positions (a vision frontend's ``frontend_tokens`` patch positions
        are dropped before it, as in the reference); ``aux`` is the MoE
        router loss summed over the MoE sublayers (0 without MoE FFNs),
        weighted by ``router_aux_weight`` in the total. ``enc_embeds`` is
        ignored by an arch without an encoder, as the reference ignores it.
        Where the reference's CE would fail on mismatched shapes (a vision
        arch without its patches, patches given to an arch that drops none,
        tokens and targets of different lengths) this raises ``ValueError``."""
        cfg = self.cfg
        tokens, targets = batch["tokens"], batch["targets"]
        patches = batch.get("patch_embeds")
        drop = cfg.frontend_tokens if cfg.frontend == "vision_patches" else 0
        positions = tokens.shape[1] + (patches.shape[1] if patches is not None else 0)
        if positions - drop != targets.shape[1]:
            raise ValueError(
                f"{cfg.name}: {tokens.shape[1]} tokens"
                f"{f' after {patches.shape[1]} patch positions' if patches is not None else ''}"
                f", {drop} frontend positions dropped before the CE, against "
                f"{targets.shape[1]} targets")
        x, aux = self._hidden_aux(params, tokens, remat=remat, dtype=dtype,
                                  frontend_embeds=patches, enc_embeds=batch.get("enc_embeds"))
        if drop:
            x = x[:, drop:]
        # a fill where aux is a number (no MoE FFN), not a host copy
        aux = aux.to(F32) if torch.is_tensor(aux) else torch.full((), aux, dtype=F32,
                                                                   device=x.device)
        name = "embed" if cfg.tie_embeddings else "lm_head"
        if spmd.is_dtensor(params[name]):
            # FSDP: the head's weight gathered once for every CE chunk and its
            # recompute (``head`` passes a gathered one on), one reduce-scatter
            params = dict(params, **spmd.gather_for_use({name: params[name]}, x.dtype))
        ce = chunked_ce(lambda xc: self.head(params, xc), x, targets)
        return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}

    # --- serving ---
    def _attn_cache_len(self, kv_len: int, window: Optional[int]) -> int:
        if window and 0 < window <= kv_len:
            return window  # ring buffer
        return kv_len + 128  # headroom so full-attn decode never wraps

    def cache_spec(self, batch: int, kv_len: int, dtype=torch.bfloat16,
                   enc_len: Optional[int] = None) -> dict:
        """(shape, dtype) for every leaf of a decode-ready cache at kv_len;
        an encoder-decoder's cross K/V holds ``enc_len`` (default kv_len)
        encoder positions."""
        cfg = self.cfg
        K, hd = cfg.num_kv_heads, cfg.head_dim
        n = self.n_super
        blocks, cross = {}, {}
        for i in range(self.period):
            if self.kinds[i] == "attn":
                smax = self._attn_cache_len(kv_len, self.windows[i])
                if self.kv_quant:
                    attn = {"k_q": ((n, batch, smax, K, hd), torch.int8),
                            "v_q": ((n, batch, smax, K, hd), torch.int8),
                            "k_s": ((n, batch, smax, K), F32),
                            "v_s": ((n, batch, smax, K), F32)}
                else:
                    attn = {"k": ((n, batch, smax, K, hd), dtype),
                            "v": ((n, batch, smax, K, hd), dtype)}
                attn["pos_ids"] = ((n, batch, smax), torch.int32)
                blocks[f"sub{i}"] = {"attn": attn}
                if cfg.is_encoder_decoder:
                    senc = enc_len or kv_len
                    cross[f"sub{i}"] = {"k": ((n, batch, senc, K, hd), dtype),
                                        "v": ((n, batch, senc, K, hd), dtype),
                                        "pos_ids": ((n, batch, senc), torch.int32)}
            else:
                blocks[f"sub{i}"] = {"mamba": {
                    name: ((n,) + shape, dt)
                    for name, (shape, dt) in mamba_cache_decl(cfg, batch, dtype).items()
                }}
        out = {"lengths": ((batch,), torch.int32), "blocks": blocks}
        if cfg.is_encoder_decoder:
            out["cross"] = cross
        return out

    def cache_axes(self, cache_spec: dict) -> dict:
        """Logical sharding axes for every leaf of a cache tree (a
        ``cache_spec``, or a cache), by leaf name."""

        def one(names):
            lead = ("layers",) if "blocks" in names or "cross" in names else ()
            name = names[-1]
            if name == "lengths":
                return ("batch",)
            if name in ("k", "v", "k_q", "v_q"):
                return lead + ("batch", "kv_seq", "kv_heads", "head_dim")
            if name in ("k_s", "v_s"):
                return lead + ("batch", "kv_seq", "kv_heads")
            if name == "pos_ids":
                return lead + ("batch", "kv_seq")
            if name == "ssm":
                return lead + ("batch", "ssm_heads", None, None)
            if name == "conv":
                return lead + ("batch", None, "conv_ch")
            raise ValueError(f"unknown cache leaf {names}")

        def rec(node, names):
            if isinstance(node, dict):
                return {k: rec(v, names + (k,)) for k, v in node.items()}
            return one(names)

        return rec(cache_spec, ())

    def init_cache(self, batch: int, kv_len: int, dtype=torch.bfloat16,
                   enc_len: Optional[int] = None) -> dict:
        """Empty cache: zero K/V, scales and SSM/conv state, pos_ids -1
        (empty slot), lengths 0."""

        def make(spec):
            if isinstance(spec, dict):
                return {k: make(v) for k, v in spec.items()}
            shape, dt = spec
            if dt == torch.int32:
                return torch.full(shape, -1, dtype=dt, device=self.device)
            return torch.zeros(shape, dtype=dt, device=self.device)

        cache = make(self.cache_spec(batch, kv_len, dtype, enc_len))
        cache["lengths"] = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        return cache

    def prefill(self, params, tokens, *, kv_len: Optional[int] = None,
                frontend_embeds=None, enc_embeds=None, dtype=torch.bfloat16):
        """Process a full prompt (frontend positions first, where given);
        returns (last_logits, decode-ready cache)."""
        x = self.embed(params, tokens, frontend_embeds, dtype)
        B, S = x.shape[:2]
        kv_len = kv_len or S
        positions = self._positions(B, S, x.device)
        enc_out = self._encoder_out(params, enc_embeds, dtype)
        x, caches, _ = self._run_blocks(params, x, positions=positions, want_cache=True,
                                        enc_out=enc_out)
        x = rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self.head(params, x[:, -1:, :])[:, 0]
        return logits, self._finalize_prefill_cache(caches, B, S, kv_len, x.device)

    def _finalize_prefill_cache(self, caches, B, S, kv_len, device):
        """Pad/ring-place prefill K/V (and int8 scales) into the decode-cache
        layout; stack the mamba state and the cross K/V as they are."""

        def stack(i, kind):
            names = caches[0][f"sub{i}"][kind]
            return {n: torch.stack([c[f"sub{i}"][kind][n] for c in caches]) for n in names}

        blocks, cross = {}, {}
        for i in range(self.period):
            if self.kinds[i] == "mamba":
                blocks[f"sub{i}"] = {"mamba": stack(i, "mamba")}
                continue
            if "cross" in caches[0][f"sub{i}"]:
                cross[f"sub{i}"] = stack(i, "cross")
            smax = self._attn_cache_len(kv_len, self.windows[i])
            sub = {}
            for name, leaf in stack(i, "attn").items():
                fill = -1 if name == "pos_ids" else 0
                # a DTensor's local shard, whose slots dim is whole
                sub[name] = spmd.local_apply(partial(_slots, smax=smax, S=S, fill=fill), leaf,
                                             shape=leaf.shape[:2] + (smax,) + leaf.shape[3:])
            blocks[f"sub{i}"] = {"attn": sub}
        lengths = torch.full((B,), S, dtype=torch.int32, device=device)
        out = {"lengths": lengths, "blocks": blocks}
        if self.cfg.is_encoder_decoder:
            out["cross"] = cross
        return out

    def decode_step(self, params, cache, tokens, dtype=torch.bfloat16):
        """One decode step for every sequence. tokens: (B, S_new).

        Writes the new K/V and mamba state into ``cache`` in place. Returns
        (logits (B, V) for the last position, the cache with ``lengths``
        advanced; its cross K/V, where it has one, as it was)."""
        lengths = cache["lengths"]
        x = self.embed(params, tokens, None, dtype)
        positions = self._positions(x.shape[0], tokens.shape[1], x.device, start=lengths)
        x, _, _ = self._run_blocks(params, x, positions=positions, cache=cache["blocks"],
                                   cross=cache.get("cross"), lengths=lengths)
        x = rms_norm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self.head(params, x)[:, -1]
        out = {"lengths": lengths + tokens.shape[1], "blocks": cache["blocks"]}
        if "cross" in cache:
            out["cross"] = cache["cross"]
        return logits, out

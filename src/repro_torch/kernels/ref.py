"""Plain PyTorch versions of every kernel: the oracles the CPU tests use
and chip_smoke.py holds the kernels against on the card."""
from __future__ import annotations

import math

import torch

from ..models.layers import NEG_INF, _sdpa_dense, causal_window_mask
from ..models.ssd import ssd_chunked

F32 = torch.float32


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q (B,Sq,H,hd), k/v (B,Sk,K,hd) with implicit arange positions."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    qp = torch.arange(Sq, dtype=torch.int32, device=q.device)[None].expand(B, Sq)
    kp = torch.arange(Sk, dtype=torch.int32, device=q.device)[None].expand(B, Sk)
    return _sdpa_dense(
        q, k, v, qp, kp, window if window else None, causal, softcap or None
    )


def _scores(q, k, causal, window, softcap):
    """The oracle's float32 scores (B,K,G,Sq,Sk), scaled and capped, and
    their mask (Sq,Sk)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd).to(F32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(F32)) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, dtype=torch.int32, device=q.device)[None]
    kp = torch.arange(Sk, dtype=torch.int32, device=q.device)[None]
    return s, causal_window_mask(qp, kp, window if window else None, causal)[0]


def flash_attention_lse_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The oracle's output, and the float32 log-sum-exp of its masked,
    scaled and capped scores, (B,H,Sq) with h = kv_head * G + g."""
    B, Sq, H, _ = q.shape
    s, mask = _scores(q, k, causal, window, softcap)
    masked = torch.where(mask, s, torch.tensor(NEG_INF, dtype=F32, device=q.device))
    lse = torch.logsumexp(masked, dim=-1)
    out = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return out, lse.reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, window=0, softcap=0.0):
    """The FlashAttention-2 backward (arXiv 2307.08691, Alg. 2) written out
    in float32 from the forward's output ``o`` and log-sum-exp ``lse``
    (B,H,Sq): P = exp(S - lse), D = rowsum(dO * O), dV = P^T dO,
    dS = P * (dO V^T - D) (times 1 - (s/cap)^2 under a softcap, s the capped
    score), dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd). The G query heads
    of a KV head sum into its dK and dV. Returns (dq, dk, dv) in the inputs'
    types."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    s, mask = _scores(q, k, causal, window, softcap)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, K, G, Sq, 1)), 0.0)
    qf = q.reshape(B, Sq, K, G, hd).to(F32)
    dof = do.reshape(B, Sq, K, G, hd).to(F32)
    delta = (dof * o.reshape(B, Sq, K, G, hd).to(F32)).sum(-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    ds = p * (torch.einsum("bqkgd,bskd->bkgqs", dof, v.to(F32)) - delta[..., None])
    if softcap:
        ds = ds * (1.0 - (s / softcap) ** 2)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(F32)) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q, k, v, pos_ids, lengths, *, window=0, softcap=0.0):
    """q (B,H,hd) single token; validity from pos_ids/lengths."""
    out = _sdpa_dense(
        q[:, None],  # (B,1,H,hd)
        k,
        v,
        lengths[:, None].to(torch.int32),
        pos_ids,
        window if window else None,
        True,
        softcap or None,
    )
    return out[:, 0]


def ssd_scan_ref(x, dt, A, B_, C_, *, chunk=128, h0=None):
    """Delegates to the model's chunked SSD (itself held against the
    sequential recurrence below in the tests)."""
    return ssd_chunked(x, dt, A, B_, C_, chunk, h0=h0)


def ssd_sequential_ref(x, dt, A, B_, C_):
    """O(S) literal recurrence from a zero state: the ground truth for
    ``ssd_chunked`` itself. Returns (y (B,S,H,P), final state (B,H,P,N))."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    h = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    Af = A.to(F32)
    ys = []
    for t in range(S):
        dtt = dt[:, t].to(F32)  # (B,H)
        dA = torch.exp(dtt * Af)
        h = h * dA[..., None, None] + dtt[..., None, None] * (
            x[:, t, :, :, None].to(F32) * B_[:, t, :, None, :].to(F32)
        )
        ys.append(torch.einsum("bhpn,bhn->bhp", h, C_[:, t].to(F32)))
    return torch.stack(ys, dim=1).to(x.dtype), h

"""Plain PyTorch versions of every kernel: the oracles the CPU tests use
and chip_smoke.py holds the kernels against on the card."""
from __future__ import annotations

import torch

from ..models.layers import _sdpa_dense
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

"""Plain PyTorch versions of every kernel: the oracles the CPU tests use
and chip_smoke.py holds the kernels against on the card."""
from __future__ import annotations

import torch

from ..models.layers import _sdpa_dense


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

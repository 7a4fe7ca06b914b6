"""Plain PyTorch versions of every kernel: the oracles the CPU tests use
and chip_smoke.py holds the kernels against on the card."""
from __future__ import annotations

import math

import torch

from ..models.layers import NEG_INF, _sdpa_dense, _sdpa_dense_lse, activate, causal_window_mask
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


def tf32_round(x):
    """x (float32) rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest value with 10 mantissa bits, ties away from zero (half of the
    13 dropped bits' range added to the bit pattern, then the 13 bits
    cleared; the sign bit stands apart, so this rounds the magnitude)."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(F32)


def split_tf32(x):
    """(hi, lo): x = hi + lo to ~22 bits, both tf32, as ``csrc/tc_mma.cuh``
    splits an operand."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(F32) - hi)


def mm_split_tf32(a, b):
    """a @ b in split-TF32 (3xTF32): lo·hi + hi·lo + hi·hi, the lo·lo term
    dropped. A product of two tf32 values is exact in float32, so this is
    the tensor cores' arithmetic up to the order of the float32 sums."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def flash_attention_split_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The float32 tensor-core flash kernel's algorithm step by step, in float32,
    at the kernel's tiling (``Tf32Tiling``, at every head dim, 8 to 256). The
    G query heads of a kv head are folded into the rows (row = q * G + g);
    each tile of 32 folded rows walks stages of ``split`` x ``keys`` keys
    (``tf32_plan``: 2 x 32 at hd <= 64, 2 x 16 at hd 128, 4 x 8 at hd 256)
    from its first row's
    window edge (aligned down to a stage) to its last row's causal frontier,
    and part h of each stage goes to partial state h (the kernel's warp
    groups). Per key tile: S = Q Kᵀ in split-TF32, scaled, capped, -1e30 where
    masked and -inf past Sk (the kernel's zero-filled keys), the online
    softmax update, O += P V in split-TF32 (P split too). The partial states
    merge in order: M = max(m_h), l = sum l_h exp(m_h - M), acc likewise; l is
    clamped at 1e-30. (The kernel's warps also skip a key tile wholly outside
    their rows' range; that is exact, so it is not repeated here.) Returns
    (out in q's type, log-sum-exp (B,H,Sq) float32, h = kv_head * G + g)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G, R = H // K, (H // K) * Sq
    from .flash_attention import tf32_plan  # the wrapper's module imports this one

    plan = tf32_plan(hd)  # Tf32Tiling's kBM, kSplit and kBN
    rows, split, keys, stage = plan["rows"], plan["split"], plan["keys"], plan["stage"]
    dev = q.device
    qf = q.to(F32).reshape(B, Sq, K, G, hd).permute(0, 2, 1, 3, 4).reshape(B, K, R, hd)
    pad = (-Sk) % stage + stage  # zero keys past Sk, so that every tile is whole
    kf, vf = (torch.nn.functional.pad(t.to(F32).permute(0, 2, 1, 3), (0, 0, 0, pad))
              for t in (k, v))
    scale = 1.0 / math.sqrt(hd)
    neg = torch.tensor(NEG_INF, dtype=F32, device=dev)
    out = torch.empty((B, K, R, hd), dtype=F32, device=dev)
    lse = torch.empty((B, K, R), dtype=F32, device=dev)
    for r0 in range(0, R, rows):
        r1 = min(R, r0 + rows)
        qi = torch.arange(r0, r1, device=dev)[:, None] // G
        q_first, q_last = r0 // G, min(Sq - 1, (r0 + rows - 1) // G)
        k_end = min(Sk, q_last + 1) if causal else Sk
        k_begin = max(0, q_first - window + 1) // stage * stage if window else 0
        parts = [(torch.full((B, K, r1 - r0), NEG_INF, dtype=F32, device=dev),
                  torch.zeros((B, K, r1 - r0), dtype=F32, device=dev),
                  torch.zeros((B, K, r1 - r0, hd), dtype=F32, device=dev))
                 for _ in range(split)]
        for k0 in range(k_begin, k_end, stage):
            for h in range(split):
                kw = k0 + h * keys
                if kw >= k_end:
                    continue
                m, l, acc = parts[h]
                key = torch.arange(kw, kw + keys, device=dev)[None]
                s = mm_split_tf32(qf[:, :, r0:r1],
                                  kf[:, :, kw:kw + keys].transpose(-1, -2)) * scale
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                ok = torch.ones((r1 - r0, keys), dtype=torch.bool, device=dev)
                if causal:
                    ok &= key <= qi
                if window:
                    ok &= qi - key < window
                s = torch.where(key >= Sk, float("-inf"), torch.where(ok, s, neg))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                parts[h] = (m_new, l * alpha + p.sum(-1),
                            acc * alpha[..., None] + mm_split_tf32(p, vf[:, :, kw:kw + keys]))
        m, l, acc = parts[0]
        for m1, l1, acc1 in parts[1:]:
            mm = torch.maximum(m, m1)
            a0, a1 = torch.exp(m - mm), torch.exp(m1 - mm)
            m, l, acc = mm, l * a0 + l1 * a1, acc * a0[..., None] + acc1 * a1[..., None]
        lc = l.clamp(min=1e-30)
        out[:, :, r0:r1] = acc * (1.0 / lc)[..., None]
        lse[:, :, r0:r1] = m + torch.log(lc)
    out = out.reshape(B, K, Sq, G, hd).permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd)
    lse = lse.reshape(B, K, Sq, G).permute(0, 1, 3, 2).reshape(B, H, Sq)
    return out.to(q.dtype), lse


def flash_attention_mma_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The bf16 mma.sync flash kernel's algorithm step by step
    (``flash_mma_kernel`` at hd 8, 16 and 32), at its tiling (``mma_plan``).
    The G query heads of a kv head are folded into the rows (row = q * G +
    g); each tile of 64 folded rows walks tiles of 64 keys from its first
    row's window edge (not aligned) to its last row's causal frontier. Per
    key tile: S = Q Kᵀ of the bf16 operands in float32, scaled, capped, -1e30
    where masked and -inf past Sk (the kernel's zero-filled keys); the online
    softmax in float32 (m, alpha, p = exp(s - m), l summed from the unrounded
    p); O += P V with P rounded to bf16, in float32. l is clamped at 1e-30.
    (The kernel takes the exponentials as 2^x of scores in log2 units, the
    same function; a weight on a bf16 rounding boundary may round the other
    way there.) Returns (out in bf16, log-sum-exp (B,H,Sq) float32, h =
    kv_head * G + g)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G, R = H // K, (H // K) * Sq
    from .flash_attention import mma_plan  # the wrapper's module imports this one

    plan = mma_plan(hd)  # MmaTiling's kBM and kBN
    rows, keys = plan["rows"], plan["keys"]
    dev = q.device
    bf = torch.bfloat16
    qf = _fold(q.to(bf), B, K, G, Sq)
    kf, vf = (torch.nn.functional.pad(t.to(bf).to(F32).permute(0, 2, 1, 3), (0, 0, 0, keys))
              for t in (k, v))  # zero keys past Sk, so that every tile is whole
    scale = 1.0 / math.sqrt(hd)
    neg = torch.tensor(NEG_INF, dtype=F32, device=dev)
    out = torch.empty((B, K, R, hd), dtype=F32, device=dev)
    lse = torch.empty((B, K, R), dtype=F32, device=dev)
    for r0 in range(0, R, rows):
        r1 = min(R, r0 + rows)
        qi = torch.arange(r0, r1, device=dev)[:, None] // G
        q_first, q_last = r0 // G, min(Sq - 1, (r0 + rows - 1) // G)
        k_end = min(Sk, q_last + 1) if causal else Sk
        k_begin = max(0, q_first - window + 1) if window else 0
        m = torch.full((B, K, r1 - r0), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((B, K, r1 - r0), dtype=F32, device=dev)
        acc = torch.zeros((B, K, r1 - r0, hd), dtype=F32, device=dev)
        for k0 in range(k_begin, k_end, keys):
            key = torch.arange(k0, k0 + keys, device=dev)[None]
            s = (qf[:, :, r0:r1] @ kf[:, :, k0:k0 + keys].transpose(-1, -2)) * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            ok = torch.ones((r1 - r0, keys), dtype=torch.bool, device=dev)
            if causal:
                ok &= key <= qi
            if window:
                ok &= qi - key < window
            s = torch.where(key >= Sk, float("-inf"), torch.where(ok, s, neg))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(bf).to(F32) @ vf[:, :, k0:k0 + keys]
            m = m_new
        lc = l.clamp(min=1e-30)
        out[:, :, r0:r1] = acc * (1.0 / lc)[..., None]
        lse[:, :, r0:r1] = m + torch.log(lc)
    out = out.reshape(B, K, Sq, G, hd).transpose(1, 2).reshape(B, Sq, H, hd)
    lse = lse.reshape(B, K, Sq, G).permute(0, 1, 3, 2).reshape(B, H, Sq)
    return out.to(bf), lse


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


def _fold(x, B, K, G, Sq):
    """(B,Sq,H,...) -> (B,K,G*Sq,...) in float32, row = q * G + g."""
    rest = x.shape[3:]
    return (x.to(F32).reshape(B, Sq, K, G, *rest).transpose(1, 2)
            .reshape(B, K, Sq * G, *rest))


def flash_attention_bwd_split_ref(q, k, v, o, do, lse, *, causal=True, window=0, softcap=0.0):
    """The split-TF32 backward's algorithm step by step
    (``dkdv_tf32_kernel``, ``dkdv_merge_kernel<T>``, ``dq_tf32_kernel``; at
    hd 256 ``dkdv_tf32_cols_kernel``, ``dq_tf32_cols_kernel``; in
    csrc/flash_attention_bwd.cu), in float32 with every product in
    split-TF32 (``mm_split_tf32``: P and dS split too), at the kernels'
    tiling and schedule (``tf32_bwd_plan``, ``dkdv_schedule``): float32
    inputs at every head dim, bf16 inputs at hd 8, 16 and 32. A bf16 value
    is exact in tf32, so its lo half is 0 and the split products are the
    kernels' one (S, dP) or two (dV, dK, dQ) tf32 products. The G query
    heads of a kv head are folded into the rows (row = q * G + g). D =
    rowsum(dO * O) first. Pass 1: the segments of ``dkdv_schedule`` (the
    route's blocks an SM), each 64 keys over its rows in stages of the
    plan's ``rows`` (32; 16 at hd 256): S^T = K Q^T scaled and capped, P^T
    = exp(S^T - lse) where the key is below Sk and visible (else 0), dP^T =
    V dO^T, dS^T = P^T (dP^T - D) (times 1 - tanh^2 under a softcap), dV +=
    P^T dO, dK += dS^T Q; a tile walked by one segment is written (dK times
    the scale), the partials of a cut tile are added in slot order, then
    scaled. Pass 2: tiles of 64 rows, each over its keys in stages of the
    plan's ``dq_keys`` (32; 16 at hd 256) from its first row's window edge
    (aligned down to a stage) to its last row's causal frontier: S = Q K^T,
    P, dP = dO V^T, dS, dQ += dS K, times the scale. (The kernels' warps
    also skip a stage wholly outside their keys' or rows' range, which is
    exact; at hd 128 two warp groups take half of each stage and add their
    sums at the end, which changes only the order of float32 sums; at hd
    256 two take half of the columns each and split the B operands as they
    read them, which changes nothing. None of that is repeated here.)
    Returns (dq, dk, dv) in the inputs' types, rounded once."""
    from .flash_attention_bwd import dkdv_schedule, route, tf32_bwd_plan  # it imports this one

    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G, R = H // K, (H // K) * Sq
    if route(q.dtype, hd) != "tf32":
        raise ValueError(f"flash_attention_bwd_split_ref: {q.dtype} at hd {hd} is not the "
                         "split-TF32 route's")
    plan = tf32_bwd_plan(hd)  # Tf32BwdTiling's kKeys, kBR, kBQ, kBK
    keys, stage, dq_rows, dq_keys = plan["keys"], plan["rows"], plan["dq_rows"], plan["dq_keys"]
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qf, dof = _fold(q, B, K, G, Sq), _fold(do, B, K, G, Sq)
    delta = (dof * _fold(o, B, K, G, Sq)).sum(-1)  # (B,K,R)
    lf = lse.to(F32).reshape(B, K, G, Sq).transpose(2, 3).reshape(B, K, R)
    pad = (-Sk) % keys + keys  # zero keys past Sk, as the kernels' copies
    kf, vf = (torch.nn.functional.pad(t.to(F32).permute(0, 2, 1, 3), (0, 0, 0, pad))
              for t in (k, v))
    qpos = torch.arange(R, device=dev) // G

    def p_ds(s, ds_in, rows, key, l, d):
        """P and dS of scores s and dP ``ds_in``, rows x keys (either way
        round: ``rows`` and ``key`` broadcast to s's shape)."""
        x, f = s * scale, 1.0
        if softcap:
            th = torch.tanh(x / softcap)
            x, f = softcap * th, 1.0 - th * th
        ok = key < Sk
        if causal:
            ok = ok & (key <= qpos[rows])
        if window:
            ok = ok & (qpos[rows] - key < window)
        p = torch.where(ok, torch.exp(x - l), 0.0)
        return p, p * f * (ds_in - d)

    dk = torch.zeros((B, K, Sk + pad, hd), dtype=F32, device=dev)
    dv = torch.zeros_like(dk)
    items, tiles, _ = dkdv_schedule(Sq, Sk, G, bool(causal), int(window or 0), B * K, hd,
                                    q.dtype)
    part = {}
    for j, lo, hi, slot in items:
        k0 = j * keys
        kt, vt = kf[:, :, k0:k0 + keys], vf[:, :, k0:k0 + keys]
        key = torch.arange(k0, k0 + keys, device=dev)[:, None]
        dka = torch.zeros((B, K, keys, hd), dtype=F32, device=dev)
        dva = torch.zeros_like(dka)
        for r in range(lo, hi, stage):
            rows = torch.arange(r, min(r + stage, hi), device=dev)
            qr, dr = qf[:, :, rows], dof[:, :, rows]
            st = mm_split_tf32(kt, qr.transpose(-1, -2))  # (B,K,keys,rows)
            dpt = mm_split_tf32(vt, dr.transpose(-1, -2))
            p, ds = p_ds(st, dpt, rows[None], key, lf[:, :, None, rows], delta[:, :, None, rows])
            dva = dva + mm_split_tf32(p, dr)
            dka = dka + mm_split_tf32(ds, qr)
        if slot < 0:
            dk[:, :, k0:k0 + keys], dv[:, :, k0:k0 + keys] = dka * scale, dva
        else:
            part[slot] = (dka, dva)
    for j, first, n, _ in tiles:
        if n < 2:
            continue
        dka, dva = part[first]
        for i in range(first + 1, first + n):
            dka, dva = dka + part[i][0], dva + part[i][1]
        dk[:, :, j * keys:(j + 1) * keys], dv[:, :, j * keys:(j + 1) * keys] = dka * scale, dva

    dq = torch.zeros((B, K, R, hd), dtype=F32, device=dev)
    for r0 in range(0, R, dq_rows):
        rows = torch.arange(r0, min(R, r0 + dq_rows), device=dev)
        q_first, q_last = r0 // G, min(Sq - 1, (r0 + dq_rows - 1) // G)
        k_end = min(Sk, q_last + 1) if causal else Sk
        k_begin = max(0, q_first - window + 1) // dq_keys * dq_keys if window else 0
        qr, dr = qf[:, :, rows], dof[:, :, rows]
        acc = torch.zeros((B, K, rows.numel(), hd), dtype=F32, device=dev)
        for kb in range(k_begin, k_end, dq_keys):
            kt, vt = kf[:, :, kb:kb + dq_keys], vf[:, :, kb:kb + dq_keys]
            key = torch.arange(kb, kb + dq_keys, device=dev)[None]
            s = mm_split_tf32(qr, kt.transpose(-1, -2))  # (B,K,rows,keys)
            dp = mm_split_tf32(dr, vt.transpose(-1, -2))
            _, ds = p_ds(s, dp, rows[:, None], key, lf[:, :, rows, None], delta[:, :, rows, None])
            acc = acc + mm_split_tf32(ds, kt)
        dq[:, :, r0:r0 + rows.numel()] = acc * scale
    dq = dq.reshape(B, K, Sq, G, hd).transpose(1, 2).reshape(B, Sq, H, hd)
    dk, dv = (t[:, :, :Sk].transpose(1, 2) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def decode_attention_ref(q, k, v, pos_ids, lengths, *, window=0, softcap=0.0,
                         return_lse=False):
    """q (B,H,hd) single token; validity from pos_ids/lengths. With
    ``return_lse``: (o (B,H,hd) float32, each head's log-sum-exp (B,H) of
    its scaled, capped scores over the valid slots, -inf where none is
    valid), in float32 throughout; a row with no valid slot gives the mean
    of V over every slot, as without it."""
    if return_lse:
        return _decode_lse_ref(q, k, v, pos_ids, lengths, window, softcap)
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


def _decode_lse_ref(q, k, v, pos_ids, lengths, window, cap):
    out, lse = _sdpa_dense_lse(q[:, None], k, v, lengths[:, None].to(torch.int32), pos_ids,
                               window if window else None, True, cap or None)
    return out[:, 0], lse[:, 0]


def decode_attention_split_ref(q, k, v, pos_ids, lengths, *, window=0, softcap=0.0,
                               split=64, return_lse=False):
    """The split-KV decode kernel's algorithm (flash-decoding) step by step,
    in float32: per split of ``split`` slots, the partial (m, l, acc) over
    its valid slots only (a split with none has l = 0 and is skipped); the
    splits merged in split order, o = sum acc exp(m - M) / max(L, 1e-30); a
    row with no valid slot at all gives the mean of V over all Smax slots,
    as the reference's -1e30 scores do. Returns (B,H,hd) in q's type; with
    ``return_lse``, (o (B,H,hd) float32, lse = M + log L (B,H), -inf for a
    row with no valid slot), as the kernel's merge writes them."""
    B, H, hd = q.shape
    Smax, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, K, G, hd).to(F32)
    qpos = lengths.to(torch.int64)[:, None]
    pos = pos_ids.to(torch.int64)
    valid = (pos >= 0) & (pos <= qpos)
    if window:
        valid &= (qpos - pos) < window
    neg = torch.tensor(float("-inf"), dtype=F32, device=q.device)
    parts = []
    for j0 in range(0, Smax, split):
        ok = valid[:, j0:j0 + split][:, None, None, :]  # (B,1,1,L)
        s = torch.einsum("bkgd,blkd->bkgl", qf, k[:, j0:j0 + split].to(F32)) * (1.0 / math.sqrt(hd))
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        has = ok.any(-1).expand(B, K, G)
        m = torch.where(ok, s, neg).amax(-1)
        p = torch.where(ok, torch.exp(s - torch.where(has, m, 0.0)[..., None]), 0.0)
        acc = torch.einsum("bkgl,blkd->bkgd", p, v[:, j0:j0 + split].to(F32))
        parts.append((m, p.sum(-1), acc, has))
    any_valid = torch.stack([h for *_, h in parts]).any(0)
    M = torch.stack([torch.where(h, m, neg) for m, _, _, h in parts]).amax(0)
    M = torch.where(any_valid, M, 0.0)
    L = torch.zeros_like(M)
    acc = torch.zeros_like(qf)
    for m, l, a, h in parts:
        w = torch.where(h, torch.exp(m - M), 0.0)
        L = L + l * w
        acc = acc + a * w[..., None]
    out = acc / L.clamp(min=1e-30)[..., None]
    mean = v.to(F32).mean(1)[:, :, None, :]  # (B,K,1,hd)
    out = torch.where(any_valid[..., None], out, mean)
    if return_lse:
        lse = torch.where(any_valid, M + torch.log(L), float("-inf"))
        return out.reshape(B, H, hd), lse.reshape(B, H)
    return out.reshape(B, H, hd).to(q.dtype)


def ssd_scan_split_ref(x, dt, A, B_, C_, *, chunk=128):
    """The chunk-parallel SSD kernel's algorithm (arXiv 2405.21060, section
    6) step by step, from a zero state: (a) each chunk's own state
    xᵀ (B ⊙ exp(cs_last - cs) dt) and cs_last; (b) the states passed over
    the chunks in order, state_c+1 = exp(cs_last_c) state_c + S_c; (c) each
    chunk's output, the intra-chunk product plus (C ⊙ exp(cs)) times the
    state entering the chunk. Returns (y (B,S,H,P) in x's type, final state
    (B,H,P,N) float32)."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc, Q = S // chunk, chunk
    xr = x.reshape(Bsz, nc, Q, H, P).to(F32)
    dtr = dt.reshape(Bsz, nc, Q, H).to(F32)
    Br = B_.reshape(Bsz, nc, Q, H, N).to(F32)
    Cr = C_.reshape(Bsz, nc, Q, H, N).to(F32)
    cs = torch.cumsum(dtr * A.to(F32), dim=2)  # (B,nc,Q,H) inclusive
    cl = cs[:, :, -1]  # (B,nc,H)
    # (a) chunk states
    w = torch.exp(cl[:, :, None] - cs) * dtr
    own = torch.einsum("bcqhp,bcqhn->bchpn", xr, Br * w[..., None])
    # (b) state passing
    h = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = torch.exp(cl[:, c])[..., None, None] * h + own[:, c]
    entering = torch.stack(entering, dim=1)  # (B,nc,H,P,N)
    # (c) chunk outputs; the upper triangle is masked before the exp
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))[..., None]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,nc,Q,K,H)
    decay = torch.exp(torch.where(tri, diff, torch.tensor(float("-inf"), dtype=F32,
                                                          device=x.device)))
    M = torch.einsum("bcqhn,bckhn->bcqkh", Cr, Br) * decay * dtr[:, :, None]
    y = torch.einsum("bcqkh,bckhp->bcqhp", M, xr)
    y = y + torch.einsum("bcqhn,bchpn->bcqhp", Cr * torch.exp(cs)[..., None], entering)
    return y.reshape(Bsz, S, H, P).to(x.dtype), h


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


def moe_gathered_ref(x, eidx, gate, wi, wg, wo, *, e0=0, act="silu"):
    """The ``moe_decode`` kernel's algorithm step by step (x (B, D), eidx
    (B, K), gate (B, K) in x's type, wi/wg (E_l, D, F), wo (E_l, F, D)):
    expert by expert, the pairs p = b K + k that chose it (e = eidx - e0),
    their products with its weights rounded to x's type dt as loaded, as
    float32 sums; g and i each rounded to dt, then h = dt(dt(act(g)) * i),
    hg = dt(h * gate) and the pair's output dt(hg Wo[e]); then each token's
    K outputs added in k order, rounded to dt after each add (0 for a token
    whose every choice lies outside [e0, e0 + E_l)). Reads the ids to the
    host; the kernel does not."""
    B, D = x.shape
    K = eidx.shape[1]
    dt = x.dtype

    def rnd(t):
        return t.to(dt).to(F32)

    pair_e = (eidx.reshape(B * K) - e0).tolist()
    xf, gf = x.to(F32), gate.reshape(B * K).to(F32)
    yp = torch.zeros((B * K, D), dtype=F32, device=x.device)
    for e in sorted({e for e in pair_e if 0 <= e < wi.shape[0]}):
        sel = [p for p, pe in enumerate(pair_e) if pe == e]
        xe = xf[[p // K for p in sel]]  # (n, D)
        g = rnd(xe @ wg[e].to(dt).to(F32))
        i = rnd(xe @ wi[e].to(dt).to(F32))
        h = rnd(rnd(activate(g, act)) * i)
        hg = rnd(h * gf[sel][:, None])
        yp[sel] = rnd(hg @ wo[e].to(dt).to(F32))
    y = torch.zeros((B, D), dtype=F32, device=x.device)
    for b in range(B):
        first = True
        for k in range(K):
            if 0 <= pair_e[b * K + k] < wi.shape[0]:
                y[b] = yp[b * K + k] if first else rnd(y[b] + yp[b * K + k])
                first = False
    return y.to(dt)

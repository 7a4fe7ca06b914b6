"""Operations and bytes that one kernel call needs, from its shapes.

A call's least time is the larger of its operations over ``PEAK_FLOPS`` and
its bytes over ``HBM_BYTES_PER_S`` (``least_s``). The operations are the
algorithm's: each multiply-add of a kept query-key pair, or of a token's
chosen expert, counted once as two operations, whatever route computes it
(a split-TF32 route runs three products for one; a bf16 or CUDA-core route
one), and every type goes over the one peak, so no route can read a share
above 100 % by being counted differently. The bytes are each input byte
read once and each output byte written once, of what these inputs need:
the keys and values of the valid slots, the weights of the distinct experts
that the step's tokens chose.

Shares are taken against NVIDIA's data sheet for one H100 SXM at its full
700 W limit (dense, no sparsity): 989 TFLOP/s on the tensor cores in bf16,
the highest rate of any type the served models use, and 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import re

PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

#: device kernel names of each counted kernel (demangled, as the profiler
#: reports them)
KERNEL_NAMES = {
    "flash_fwd": re.compile(r"\bflash_(?:tf32|wg|mma)_kernel\b"),
    "decode_attention": re.compile(r"(?:^|[\s:])split_kernel<"),
    "moe_decode": re.compile(r"\bmoe_(?:up|down|combine)_kernel\b"),
}


#: the kernel that marks one call of a class that launches several
FIRST_KERNEL = {"moe_decode": "moe_up_kernel"}


def kernel_class(name: str) -> str | None:
    for cls, pat in KERNEL_NAMES.items():
        if pat.search(name):
            return cls
    return None


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def causal_pairs(sq: int, sk: int, window: int | None = None) -> int:
    """Kept (query, key) pairs of a causal call whose queries are the last
    ``sq`` of ``sk`` positions, with an optional sliding window."""
    total = 0
    for i in range(sk - sq, sk):
        lo = 0 if not window else max(0, i - window + 1)
        total += i - lo + 1
    return total


def flash_fwd(B: int, S: int, H: int, K: int, hd: int, itemsize: int,
              window: int | None = None) -> tuple[float, float]:
    """A causal self-attention forward over S tokens: (operations, bytes).
    Q K^T and P V: 4 hd operations a kept pair; q, k, v read, o written."""
    flops = 4.0 * B * H * hd * causal_pairs(S, S, window)
    nbytes = float(itemsize) * B * S * hd * (2 * H + 2 * K)
    return flops, nbytes


def decode_attention(B: int, H: int, K: int, hd: int, valid: int,
                     itemsize: int) -> tuple[float, float]:
    """One new token a row against ``valid`` cached positions: (operations,
    bytes). The valid slots' keys, values and int32 positions read, the
    row's length and q read, o written."""
    flops = 4.0 * B * H * hd * valid
    nbytes = (float(itemsize) * B * (2 * valid * K * hd + 2 * H * hd)
              + 4.0 * B * (valid + 1))
    return flops, nbytes


def moe_decode(B: int, top_k: int, D: int, F: int, distinct: int, w_itemsize: int,
               x_itemsize: int) -> tuple[float, float]:
    """One decode step's gated experts over B tokens: (operations, bytes).
    Each (token, choice) pair's up, gate and down products (3 D F
    multiply-adds); the ``distinct`` chosen experts' three weight matrices
    read once, x, the ids and gates read, y written."""
    flops = 2.0 * 3 * B * top_k * D * F
    nbytes = (float(w_itemsize) * distinct * 3 * D * F
              + float(x_itemsize) * 2 * B * D + 8.0 * B * top_k + float(x_itemsize) * B * top_k)
    return flops, nbytes

"""The gathered MoE decode: the wrapper of ``csrc/moe_decode.cu``.

Replaces no TPU kernel: the reference's ``_moe_gathered``
(``src/repro/models/layers.py``) is ``jnp.take`` of the chosen experts'
weights and two einsums inside its jitted step, which PyTorch cannot do
without copying those weights ((B, K, D, F) a weight), and the port's plain
loop (``models/layers.py::_gathered_loop``) reads the chosen ids to the host.
The kernel reads them on the card, so the decode step of an MoE arch is
captured whole (``launch/graphs.py``).

``moe_decode(x, eidx, gate, wi, wg, wo, e0=, act=)``: x (B, D) float32 or
bfloat16 with B <= 16 and B K <= 64, eidx (B, K) int64, gate (B, K) in x's
type, wi, wg (E_l, D, F) and wo (E_l, F, D) in float32 (or bfloat16 under
bfloat16 x); returns y (B, D) in x's type: the sum over k of gate[b,k]
(silu(x_b wg[e]) * (x_b wi[e])) wo[e], e = eidx[b,k] - e0, a choice outside
[e0, e0 + E_l) adding nothing. ``e0`` and an F that is a slice of the
experts' hidden dim are a mesh rank's share (``parallel/spmd.py::moe_apply``).
The weights are read in their stored type and rounded to x's as they are
loaded; F and D must be multiples of 16 bytes' worth of weights, and every
pointer 16-byte aligned. Only ``act="silu"`` (every MoE config's) is taken.
The three launches' grids and float32 workspaces come from ``plan``, a
function of the shapes alone, so replays of a captured step and two runs
give the same bits.

On a CPU tensor the wrapper computes the plain version (``_gathered_loop``,
whose ``num_experts`` it takes for a traced step's rule); on a CUDA tensor it
launches the kernel or raises, also for a CUDA input that requires grad
while grad mode is on (no path differentiates a decode step).
``moe_decode.launches`` counts the calls that launch it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..models.layers import _gathered_loop
from . import _build

MAX_TOKENS = 16
MAX_PAIRS = 64  # kMaxPairs in the source
ACTS = ("silu",)
WARPS = 4  # kWarps in the source
CHUNK = 256  # kChunk: rows staged at once, a split's least rows
#: blocks a pass aims to give the card (132 SMs x 4), counting every
#: expert a pair could choose as chosen; a constant, so that the bits do not
#: depend on the card
TARGET_BLOCKS = 4 * 132
_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def plan(B: int, K: int, D: int, F: int, E_l: int, w_itemsize: int) -> dict:
    """The tiles, grids and workspaces of a call at these shapes. ``np``: the
    pairs a thread keeps (B rounded up to a power of two, the most pairs one
    expert takes when a token's K ids are distinct). ``vec``: weights a
    thread loads at once (16 bytes), ``tile`` a block's columns. The up pass
    splits D's rows and the down pass F's into as many runs as give
    TARGET_BLOCKS blocks over the min(E_l, B K) experts the pairs can choose
    (no run under CHUNK rows); ``up_floats`` and ``down_floats`` are their
    float32 partial sums."""
    vec = 16 // w_itemsize
    tile = WARPS * 32 * vec
    active = min(E_l, B * K)

    def split(rows, tiles, grids):
        s = max(1, min(math.ceil(TARGET_BLOCKS / (tiles * active * grids)),
                       math.ceil(rows / CHUNK)))
        per = math.ceil(rows / s)
        return math.ceil(rows / per), per

    up_tiles, down_tiles = math.ceil(F / tile), math.ceil(D / tile)
    s_up, rows_up = split(D, up_tiles, 2)
    s_down, rows_down = split(F, down_tiles, 1)
    return {"np": 1 << max(0, B - 1).bit_length(), "vec": vec, "tile": tile,
            "up_grid": (up_tiles, E_l, 2 * s_up), "down_grid": (down_tiles, E_l, s_down),
            "s_up": s_up, "rows_up": rows_up, "s_down": s_down, "rows_down": rows_down,
            "up_floats": 2 * s_up * B * K * F, "down_floats": s_down * B * K * D}


def check(x, eidx, gate, wi, wg, wo, act) -> None:
    """Raise for what the kernel does not take (shapes, types, sizes)."""
    B, D = x.shape
    K = eidx.shape[1] if eidx.dim() == 2 else -1
    E_l, _, F = wi.shape if wi.dim() == 3 else (-1, -1, -1)
    if (eidx.shape != (B, K) or gate.shape != (B, K) or wi.shape != (E_l, D, F)
            or wg.shape != wi.shape or wo.shape != (E_l, F, D)):
        raise ValueError(f"moe_decode: x {tuple(x.shape)} eidx {tuple(eidx.shape)} gate "
                         f"{tuple(gate.shape)} wi {tuple(wi.shape)} wg {tuple(wg.shape)} "
                         f"wo {tuple(wo.shape)}")
    if act not in ACTS:
        raise ValueError(f"moe_decode: activation {act!r} not in {ACTS}")
    if not 1 <= B <= MAX_TOKENS or B * K > MAX_PAIRS:
        raise ValueError(f"moe_decode: {B} tokens x {K} choices; the kernel takes at most "
                         f"{MAX_TOKENS} tokens and {MAX_PAIRS} pairs")
    if eidx.dtype != torch.int64:
        raise TypeError(f"moe_decode: eidx {eidx.dtype}, need int64")
    if x.dtype not in (torch.float32, torch.bfloat16) or gate.dtype != x.dtype:
        raise TypeError(f"moe_decode: x {x.dtype} and gate {gate.dtype}: need one of "
                        f"float32, bfloat16")
    wdt = {wi.dtype, wg.dtype, wo.dtype}
    if len(wdt) != 1 or wi.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"moe_decode: weights {sorted(map(str, wdt))} under x {x.dtype}: need "
                        f"float32, or x's type")
    vec = 16 // wi.element_size()
    if F % vec or D % vec:
        raise ValueError(f"moe_decode: D {D} and F {F} must be multiples of {vec}")


def moe_decode(x, eidx, gate, wi, wg, wo, *, e0: int = 0, num_experts=None, act: str = "silu"):
    if x.device.type == "cpu":
        return _gathered_loop(x, eidx, gate, wi, wg, wo, e0=e0, num_experts=num_experts,
                              act=act)
    _build.refuse_fake("moe_decode", x, eidx, gate, wi, wg, wo)
    _build.refuse_grad("moe_decode", x, gate, wi, wg, wo)
    check(x, eidx, gate, wi, wg, wo, act)
    _build.check_cuda_inputs("moe_decode", x.dtype, x, eidx, gate)
    _build.check_cuda_inputs("moe_decode", wi.dtype, wi, wg, wo)
    if x.device != wi.device:
        raise ValueError(f"moe_decode: x on {x.device}, the weights on {wi.device}")
    for name, t in (("wi", wi), ("wg", wg), ("wo", wo)):
        if t.data_ptr() % 16:
            raise ValueError(f"moe_decode: {name} is not on a 16-byte boundary")
    B, D = x.shape
    K = eidx.shape[1]
    E_l, _, F = wi.shape
    pl = plan(B, K, D, F, E_l, wi.element_size())
    y = torch.empty_like(x)
    up = torch.empty(pl["up_floats"], dtype=torch.float32, device=x.device)
    down = torch.empty(pl["down_floats"], dtype=torch.float32, device=x.device)
    fn = _build.load("moe_decode", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(
            0 if x.dtype == torch.float32 else 1, 0 if wi.dtype == torch.float32 else 1,
            pl["np"], x.data_ptr(), eidx.data_ptr(), gate.data_ptr(), wi.data_ptr(),
            wg.data_ptr(), wo.data_ptr(), up.data_ptr(), down.data_ptr(), y.data_ptr(),
            B, K, D, F, E_l, int(e0), pl["s_up"], pl["rows_up"], pl["s_down"],
            pl["rows_down"], stream,
        )
        _build.count_launch(moe_decode, stream=stream)
    _build.raise_on_error("moe_decode", rc)
    return y


moe_decode.launches = 0

"""The plan of the bf16 flash forward (``flash_wg_kernel`` in
``csrc/flash_attention.cu``): its shared memory, ring and TMA boxes, held
to the sizes the source's ``WgTiling`` computes, and the wrapper's checks
that need no device. Pure Python, checked exactly on the CPU.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels.flash_attention import check_route, wg_plan
from repro_torch.perf.hw import H100

CSRC = Path(flash_module.__file__).parents[1] / "csrc"


@pytest.mark.parametrize("hd", flash_module.WG_HEAD_DIMS)
def test_wg_plan_fits_shared_memory_and_boxes_of_64_columns(hd):
    plan = wg_plan(hd)
    assert plan["smem_bytes"] <= H100.vmem_bytes  # what one block may use
    keys = 64 if hd == 256 else 128  # hd 256: Q and the rings must fit 227 KiB
    assert plan["box"] == (flash_module.WG_BOX_COLS, plan["keys"]) == (64, keys)
    assert plan["boxes"] == 2 * hd // 64  # K and V, hd/64 boxes each
    assert plan["tx_bytes"] == plan["boxes"] * 64 * plan["keys"] * 2
    assert plan["threads"] == 3 * 128 and plan["rows"] == 2 * 64
    producer, consumer = plan["regs"]  # one warp of each warpgroup on each SM quarter
    assert 32 * (producer + 2 * consumer) <= 65536 // 4
    # Q of both consumers, the K and V rings and their barriers (a full and
    # an empty one a stage of each ring), after 1024 bytes of alignment slack
    ring = 2 * plan["stages"] * (hd // 64) * 64 * plan["keys"] * 2
    assert plan["smem_bytes"] == 1024 + plan["rows"] * hd * 2 + ring + 4 * plan["stages"] * 8


def test_wg_plan_refuses_other_head_dims():
    for hd in (8, 16, 32):
        with pytest.raises(ValueError):
            wg_plan(hd)


def _wg_tiling(hd):
    """Every ``static constexpr int`` of the source's ``WgTiling<hd>``,
    evaluated in order (``kSubTile`` from csrc/wgmma.cuh)."""
    head = (CSRC / "wgmma.cuh").read_text()
    env = {"HD": hd,
           "kSubTile": int(eval(re.search(r"constexpr int kSubTile = ([^;]+);", head).group(1)))}
    src = (CSRC / "flash_attention.cu").read_text()
    body = re.search(r"struct WgTiling \{(.*?)\n\};", src, re.S).group(1)
    for line in body.splitlines():
        for name, expr in re.findall(r"(k\w+) = ([^;,]+)[;,]", line.split("//")[0]):
            env[name] = eval(expr.replace("/", "//"), {}, env)  # C int arithmetic
    return env


@pytest.mark.parametrize("hd", flash_module.WG_HEAD_DIMS)
def test_wg_plan_sizes_are_the_sources(hd):
    """The plan's shared memory, box and barrier bytes are what the kernel's
    ``WgTiling<hd>`` computes, so the budget checked above is the launch's."""
    w, plan = _wg_tiling(hd), wg_plan(hd)
    assert plan["smem_bytes"] == w["kSmem"]
    assert plan["tx_bytes"] == 2 * w["kKVTile"]  # a stage's expect_tx: K and V
    assert plan["boxes"] == 2 * w["kNA"]
    assert plan["box"][0] * plan["box"][1] * 2 == w["kBox"]
    assert (plan["threads"], plan["rows"], plan["keys"], plan["stages"]) == (
        w["kThreads"], w["kBM"], w["kBN"], w["kStages"])


def test_wg_tiling_constants_match_the_source():
    """The plan's sizes are the kernel's (``WgTiling`` in the source), at
    every head dim of the route."""
    assert sorted(flash_module.WG_KEYS) == sorted(flash_module.WG_STAGES) == sorted(
        flash_module.WG_HEAD_DIMS)
    for hd in flash_module.WG_HEAD_DIMS:
        w = _wg_tiling(hd)
        assert 128 * (1 + w["kNC"]) == flash_module.WG_THREADS
        assert 64 * w["kNC"] == flash_module.WG_ROWS
        assert w["kBN"] == flash_module.WG_KEYS[hd]
        assert w["kStages"] == flash_module.WG_STAGES[hd]
        assert (w["kProducerRegs"], w["kConsumerRegs"]) == flash_module.WG_REGS


def _shifted(dtype, shape):
    """A contiguous view one element into its buffer: off a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("dtype,hd,tensor_cores", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 32, True), (torch.bfloat16, 256, True),
    (torch.float32, 64, True), (torch.float32, 8, True),
    (torch.float32, 256, True), (torch.bfloat16, 16, True)])
def test_check_route_holds_the_tensor_core_routes_to_16_bytes(dtype, hd, tensor_cores):
    """bf16 at hd 64, 128 and 256 (TMA and wgmma), bf16 at hd 8, 16 and 32
    (cp.async and mma.sync) and float32 at every head dim (split-TF32) copy
    16 bytes at a time, so they need 16-byte aligned q, k, v: every route is
    on the tensor cores."""
    q = torch.zeros((1, 8, 4, hd), dtype=dtype)
    kv = torch.zeros((1, 8, 2, hd), dtype=dtype)
    check_route(q, kv, kv)
    assert tensor_cores
    with pytest.raises(ValueError, match="16-byte"):
        check_route(q, _shifted(dtype, (1, 8, 2, hd)), kv)


def test_check_route_refuses_what_no_route_takes():
    q, kv = torch.zeros((1, 8, 4, 64)), torch.zeros((1, 8, 2, 64))
    with pytest.raises(TypeError):
        check_route(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError):  # head_dim 24
        check_route(torch.zeros((1, 8, 4, 24)), torch.zeros((1, 8, 2, 24)),
                    torch.zeros((1, 8, 2, 24)))
    with pytest.raises(ValueError):  # H not a multiple of K
        check_route(torch.zeros((1, 8, 5, 64)), kv, kv)
    with pytest.raises(ValueError):  # k and v differ
        check_route(q, kv, torch.zeros((1, 9, 2, 64)))


def test_check_route_refuses_folded_rows_past_the_bf16_kernels_int_indices():
    """The bf16 kernel holds a block's folded rows r = q G + g in int: G Sq
    at 2^31 is refused (meta tensors: no memory), the float32 route at the
    same shape is not this check's."""
    q = torch.empty((1, 2**28, 8, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 2**28, 1, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        check_route(q, kv, kv)
    fits = torch.empty((1, 2**20, 8, 64), dtype=torch.bfloat16, device="meta")
    check_route(fits, kv[:, :2**20], kv[:, :2**20])
    check_route(q.float(), kv.float(), kv.float())

"""Hardware models: the TPU v5e the JAX package targets, and the H100 the
port runs on. Pure data, plus the bound of one kernel call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class HwSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12  # FLOP/s per chip
    hbm_bandwidth: float = 819e9  # B/s per chip
    ici_link_bandwidth: float = 50e9  # B/s per link
    hbm_bytes: int = 16 * 1024**3  # 16 GiB per chip
    vmem_bytes: int = 128 * 1024**2  # ~128 MiB VMEM
    # pricing for the SLA cost model; unit: $/chip-hour.
    # Ratio mirrors the paper's spot-VM vs cloud-function gap (9-24x, §4.3).
    reserved_price: float = 1.2
    elastic_price_multiplier: float = 10.0
    #: float32 outside the matrix units (None where the spec gives none)
    peak_flops_f32: Optional[float] = None
    #: tf32 on the matrix units (None where the spec gives none)
    peak_flops_tf32: Optional[float] = None


V5E = HwSpec()

#: NVIDIA H100 SXM, dense rates at the full 700 W limit (NVIDIA data
#: sheet): 989 TFLOP/s bf16 and 495 TFLOP/s tf32 on the tensor cores,
#: 67 TFLOP/s float32 on the CUDA cores, 80 GB HBM3 at 3.35 TB/s, NVLink
#: 450 GB/s each way.
#: ``vmem_bytes`` is the shared memory one thread block may use.
H100 = HwSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    ici_link_bandwidth=450e9,
    hbm_bytes=80 * 10**9,
    vmem_bytes=232_448,
    peak_flops_f32=67e12,
    peak_flops_tf32=495e12,
)


def kernel_bound(flops: float, hbm_bytes: float, *, f32: bool, split_tf32: bool = False,
                 hw: HwSpec = H100) -> tuple[float, str]:
    """Least time one kernel call could take on ``hw``, and what bounds it.

    The larger of ``hbm_bytes`` over the memory rate and ``flops`` over the
    peak rate for the operands' type: float32 on the CUDA cores, else bf16
    on the tensor cores. With ``split_tf32`` (float32 only) the float32
    products run on the tensor cores as three tf32 products each
    (lo·hi + hi·lo + hi·hi), so 3 x ``flops`` at the tf32 rate. Returns
    (seconds, "bytes" | "operations").
    """
    if split_tf32 and not f32:
        raise ValueError("split_tf32 is a float32 route")
    if split_tf32:
        peak, flops = hw.peak_flops_tf32, 3 * flops
    else:
        peak = hw.peak_flops_f32 if f32 else hw.peak_flops_bf16
    if peak is None:
        raise ValueError(f"{hw.name} gives no {'tf32' if split_tf32 else 'float32'} peak")
    t_ops = flops / peak
    t_bytes = hbm_bytes / hw.hbm_bandwidth
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

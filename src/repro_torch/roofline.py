"""Port of ``repro/roofline.py``: roofline analysis from compiled artifacts,
with one NVIDIA H100 SXM's peaks in place of the TPU v5e constants.

The measured artifact is the program's aten graph (``repro_torch.
hlo_analysis``, the counterpart of HLO text): FLOPs by the precision they
run in, bytes moved, and collective link bytes.  Three terms:

    compute    = sum over precisions of FLOPs / that precision's peak
                 (989 TFLOP/s bf16 and fp16 on the tensor cores, 67 f32
                 outside them; an f32 matmul runs on TF32 tensor cores at
                 495 when ``torch.get_float32_matmul_precision()`` is not
                 ``"highest"``)
    memory     = bytes / HBM bandwidth            (3.35 TB/s)
    collective = ring-model link bytes / link bw  (NVLink 4: 450 GB/s a
                 direction; 0 on one card)

Estimated step time = max(terms) (classic roofline).  Collective byte model
per op (g = participating group size, sz = per-device result bytes):
    all-gather         sz * (g-1)/g
    reduce-scatter     sz * (g-1)          (operand is g * result)
    all-reduce         2 * sz * (g-1)/g    (RS + AG phases)
    all-to-all         sz * (g-1)/g
    collective-permute sz

The operation and byte counts of the four hand-written kernels
(:func:`flash_cost`, :func:`rmsnorm_cost`, :func:`rglru_cost`,
:func:`wkv6_cost`) live here too: ``chip_smoke.py``'s bounds and the
analyzer's kernel nodes read the same counts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

__all__ = ["CollectiveOp", "HBM_BW", "HBM_BYTES", "KernelCost", "LINK_BW",
           "PEAK_FLOPS", "PEAK_FLOPS_BF16", "PEAK_FLOPS_F32", "Roofline",
           "analyze", "flash_cost", "matmul_class", "model_flops_infer",
           "model_flops_train", "parse_collectives", "rglru_cost",
           "rmsnorm_cost", "wkv6_cost"]

# --- NVIDIA H100 SXM (published dense peaks, at 700 W) ----------------------
PEAK_FLOPS_BF16 = 989e12        # tensor cores, bf16 / fp16
PEAK_FLOPS_F32 = 67e12          # f32 outside the tensor cores
HBM_BW = 3.35e12                # bytes/s of HBM3
HBM_BYTES = 80e9                # bytes of HBM3
LINK_BW = 450e9                 # bytes/s a direction over NVLink 4

#: peak FLOP/s by the precision class an operation runs in
PEAK_FLOPS = {"bf16": PEAK_FLOPS_BF16, "f16": PEAK_FLOPS_BF16,
              "tf32": 494.7e12, "f32": PEAK_FLOPS_F32, "f64": 67e12,
              "fp8": 1979e12}

_CLASS_OF = {torch.bfloat16: "bf16", torch.float16: "f16",
             torch.float32: "f32", torch.float64: "f64",
             torch.float8_e4m3fn: "fp8", torch.float8_e5m2: "fp8"}


def matmul_class(dtype: torch.dtype) -> str:
    """The precision class a matmul of ``dtype`` operands runs in: f32
    runs on TF32 tensor cores unless the f32 matmul precision is
    ``"highest"``."""
    cls = _CLASS_OF.get(dtype, "f32")
    if cls == "f32" and torch.get_float32_matmul_precision() != "highest":
        return "tf32"
    return cls


class KernelCost(NamedTuple):
    """The work of one kernel call: operations (in precision class
    ``dtype``; ``matmul`` marks f32 products that TF32 may take) and the
    bytes the function must move (each input read once, each output
    written once)."""

    flops: float
    bytes: float
    dtype: str
    matmul: bool = False


def _elt(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def flash_cost(b: int, sq: int, sk: int, hq: int, hkv: int, d: int,
               causal: bool, dtype: torch.dtype) -> KernelCost:
    """Flash attention over (b, sq, hq, d) queries and (b, sk, hkv, d) keys
    and values: 4 d FLOPs a (row, key) pair the mask keeps (a causal call
    keeps row i's first min(i + 1, sk) keys), at the tensor-core peak in
    bf16 and the f32 peak otherwise."""
    if causal:
        m = min(sq, sk)
        pairs = m * (m + 1) // 2 + (sq - m) * sk
    else:
        pairs = sq * sk
    elt = _elt(dtype)
    return KernelCost(4.0 * b * hq * d * pairs,
                      (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * elt,
                      "bf16" if dtype == torch.bfloat16 else "f32")


def rmsnorm_cost(n: int, d: int, x_dtype: torch.dtype,
                 s_dtype: torch.dtype) -> KernelCost:
    """RMSNorm of n rows of width d: x read and written once, the scale
    read once; 4 f32 operations an element."""
    return KernelCost(4.0 * n * d, 2 * n * d * _elt(x_dtype)
                      + d * _elt(s_dtype), "f32")


def rglru_cost(b: int, s: int, d: int, h0: bool) -> KernelCost:
    """The RG-LRU scan over (b, s, d) f32 coefficients: log_a and b read,
    h written, and the (b, d) initial state read when given; 3 f32
    operations a step and channel."""
    n = b * s * d
    return KernelCost(3.0 * n, 3 * n * 4 + (b * d * 4 if h0 else 0), "f32")


def wkv6_cost(b: int, s: int, h: int, d: int) -> KernelCost:
    """WKV-6 over (b, s, h, d) f32 inputs: r, k, v, log_w read and the
    output written, the (h, d) bonus read; the step form's ~4 f32
    operations a state entry a step."""
    n = b * s * h * d
    return KernelCost(4.0 * n * d, 5 * n * 4 + h * d * 4, "f32")


@dataclass
class CollectiveOp:
    op: str
    result_bytes: int
    group_size: int
    line: str

    @property
    def link_bytes(self) -> float:
        g, sz = max(self.group_size, 1), self.result_bytes
        if g <= 1:
            return 0.0
        if self.op == "all-gather":
            return sz * (g - 1) / g
        if self.op == "reduce-scatter":
            return sz * (g - 1)
        if self.op == "all-reduce":
            return 2.0 * sz * (g - 1) / g
        if self.op == "all-to-all":
            return sz * (g - 1) / g
        return float(sz)  # collective-permute


def parse_collectives(graph, n_devices: int) -> list[CollectiveOp]:
    """The collectives of an aten graph (a ``GraphModule``, an exported
    program or a compiled artifact), one :class:`CollectiveOp` an
    execution (a collective inside a scan body counts once a trip)."""
    from repro_torch import hlo_analysis as ha
    hc = ha.analyze_hlo(graph, n_devices)
    return [CollectiveOp(op, rb, g, "")
            for (op, rb, g, lb, mult) in hc.collectives
            for _ in range(max(int(mult), 1))]


@dataclass
class Roofline:
    flops: float                 # per-device FLOPs (all precisions)
    hbm_bytes: float             # per-device bytes accessed
    collective_bytes: float      # per-device link bytes (ring model)
    n_devices: int
    collectives: list[CollectiveOp] = field(default_factory=list)
    model_flops: float = 0.0     # 6*N*D useful flops (per device)
    histogram: dict = field(default_factory=dict)      # op@group -> stats
    by_computation: dict = field(default_factory=dict)  # hot-spot breakdown
    flops_by_dtype: dict = field(default_factory=dict)  # class -> FLOPs

    @property
    def compute_s(self) -> float:
        if not self.flops_by_dtype:
            return self.flops / PEAK_FLOPS_BF16
        return sum(f / PEAK_FLOPS[c] for c, f in self.flops_by_dtype.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return (self.model_flops / self.flops) if self.flops else 0.0

    @property
    def peak_flops(self) -> float:
        """The peak of this program's precision mix: its FLOPs over its
        compute time (the bf16 peak for a program without FLOPs)."""
        c = self.compute_s
        return self.flops / c if c > 0 else PEAK_FLOPS_BF16

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS / (step_s * peak) — the MFU-style score, against the
        peak of the precisions the program runs in."""
        if self.step_s <= 0:
            return 0.0
        return self.model_flops / (self.step_s * self.peak_flops)

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "step_s": self.step_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_collectives": len(self.collectives),
        }


def analyze(compiled, graph=None, n_devices: int = 1,
            model_flops_global: float = 0.0) -> Roofline:
    """Build a Roofline from a compiled artifact
    (:meth:`repro_torch.hlo_analysis.Lowered.compile`), or from ``graph``
    (a ``GraphModule`` or an exported program) when it is given — the
    reference's ``hlo_text``.  The analyzer applies scan trip-count
    multipliers and extracts per-collective link bytes."""
    from repro_torch import hlo_analysis as ha
    hc = ha.analyze_hlo(graph if graph is not None else compiled, n_devices)
    cols = [CollectiveOp(op, rb, g, "") for (op, rb, g, lb, mult)
            in hc.collectives for _ in range(max(int(mult), 1))] \
        if len(hc.collectives) < 512 else []
    return Roofline(
        flops=hc.flops,
        hbm_bytes=hc.bytes,
        collective_bytes=hc.link_bytes,
        n_devices=n_devices,
        collectives=cols,
        model_flops=model_flops_global / max(n_devices, 1),
        histogram=hc.collective_histogram(),
        by_computation=hc.by_computation,
        flops_by_dtype=dict(hc.flops_by_dtype),
    )


def model_flops_train(n_params_active: int, n_tokens: int) -> float:
    """6*N*D: fwd 2ND + bwd 4ND."""
    return 6.0 * n_params_active * n_tokens


def model_flops_infer(n_params_active: int, n_tokens: int) -> float:
    return 2.0 * n_params_active * n_tokens

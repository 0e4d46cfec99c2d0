"""Roofline terms of a dry-run trace (the JAX package's
``analysis/terms.py``), on the H100 SXM's published peaks.

    compute term    = FLOPs_per_device / peak_FLOP/s              [s]
    memory term     = bytes_per_device / HBM_bw                   [s]
    collective term = collective_bytes_per_device / link_bw       [s]

The per-device numbers come from :class:`~repro_torch.analysis.trace.
StepTrace`, a trace of the step on this rank's local shards (the
reference reads them from the SPMD-compiled module's ``cost_analysis``,
which is per device too). The machine is :data:`~repro_torch.core.
roofline.H100_SXM` (67 TFLOP/s f32, 3.35 TB/s HBM, 450 GB/s NVLink each
way) where the reference uses TPU v5e's: the terms are estimates for
H100s, not measurements, and the collective term assumes every rank
reaches every other over NVLink, which a 16-way model axis spread over
8-GPU nodes would not have. MODEL_FLOPS uses the reference's convention:
6·N·D for training (fwd+bwd), 2·N·D per token for inference, with N the
active parameter count (MoE discounts inactive experts).
"""

from __future__ import annotations

import dataclasses

from ..core.roofline import H100_SXM, MachineSpec
from ..models.config import ModelConfig, WorkloadShape
from .trace import StepTrace

__all__ = ["RooflineTerms", "analyze", "model_flops"]


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_summary: str
    peak_bytes_per_dev: float      # args + temp + out
    model_flops_total: float       # analytic 6ND / 2ND
    chips: int
    machine: MachineSpec = H100_SXM

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / self.machine.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_dev / self.machine.mem_bandwidths["hbm"]

    @property
    def collective_s(self) -> float:
        if self.machine.link_bandwidth <= 0:
            return 0.0
        return self.coll_bytes_per_dev / self.machine.link_bandwidth

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound_s(self) -> float:
        """max of the three terms = perfectly-overlapped lower bound."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs × chips): remat/dispatch/padding waste."""
        total = self.flops_per_dev * self.chips
        if total <= 0:
            return 0.0
        return self.model_flops_total / total

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline lower bound:
        MODEL_FLOPS / (chips · peak · max-term)."""
        t = self.step_time_lower_bound_s
        if t <= 0:
            return 0.0
        return self.model_flops_total / (self.chips * self.machine.peak_flops
                                         * t)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_ms": round(self.compute_s * 1e3, 3),
            "memory_ms": round(self.memory_s * 1e3, 3),
            "collective_ms": round(self.collective_s * 1e3, 3),
            "dominant": self.dominant,
            "useful_flops_ratio": round(self.useful_flops_ratio, 3),
            "mfu_bound": round(self.mfu_bound, 3),
            "hbm_gb_per_dev": round(self.peak_bytes_per_dev / 1e9, 2),
            "collectives": self.coll_summary,
        }


def model_flops(cfg: ModelConfig, shape: WorkloadShape) -> float:
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def analyze(trace: StepTrace, cfg: ModelConfig, shape: WorkloadShape,
            mesh_name: str, chips: int) -> RooflineTerms:
    """The terms of one traced step (the reference's
    ``analyze_compiled``)."""
    return RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh=mesh_name,
        flops_per_dev=trace.flops, bytes_per_dev=trace.bytes_accessed,
        coll_bytes_per_dev=trace.collectives.total_bytes,
        coll_summary=trace.collectives.summary(),
        peak_bytes_per_dev=trace.peak_bytes,
        model_flops_total=model_flops(cfg, shape), chips=chips)

"""Roofline terms of a dry-run step, the twin of ``repro.launch.roofline``.

Constants of one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, the
card this port runs on; the dry-run only derives terms from counts, it
measures nothing:

    PEAK_FLOPS  989.4 TFLOP/s  dense bfloat16 on the tensor cores (NVIDIA
                               H100 SXM5 datasheet)
    HBM_BW      3.35 TB/s      HBM3 bandwidth (same datasheet)
    HBM_BYTES   80 GB          HBM3 capacity (same datasheet)
    NET_BW      50 GB/s        one 400 Gb/s NIC per GPU (NVIDIA DGX H100
                               datasheet: eight 400 Gb/s ConnectX-7 ports
                               for its eight GPUs)

A 16-wide mesh axis spans two 8-GPU nodes, so every collective on it
crosses the network: ``NET_BW``, not NVLink's, bounds the collective term.

Where the reference parses collectives out of optimized HLO, the port's
dry-run counts the functional collectives its step issues
(``repro_torch.launch.dryrun.StepCounter``) under the same five kind
names: :func:`collective_kind` maps each op to its name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

PEAK_FLOPS = 989.4e12      # bf16 FLOP/s per GPU
HBM_BW = 3.35e12           # bytes/s per GPU
HBM_BYTES = 80e9           # bytes per GPU
NET_BW = 50e9              # bytes/s per GPU

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: Functional collective op names (``torch.ops._c10d_functional`` and
#: DTensor's own all-to-all) -> the reference's kind names.
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def collective_kind(op_name: str) -> Optional[str]:
    """The kind name of a collective op by its schema's name without the
    namespace (``"all_reduce"``), or None for any other op."""
    return _KINDS.get(op_name)


@dataclasses.dataclass
class RooflineTerms:
    """Per-device roofline decomposition of one traced step."""

    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops: float               # per device
    hlo_bytes: float               # per device (HBM traffic proxy)
    collective_bytes: float        # per device
    collective_breakdown: Dict[str, int]
    model_flops_global: float      # 6*N*D (train) / 2*N*D (inference)
    bytes_per_device: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NET_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The step-time lower bound = max of the three terms (full overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (traced FLOPs x devices): how much of the traced
        compute is 'useful' — catches remat recompute, replicated work,
        padding."""
        total = self.hlo_flops * self.n_devices
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute roofline fraction if the step ran exactly at the
        bound: (model FLOPs / devices / peak) / bound_s."""
        ideal_s = self.model_flops_global / self.n_devices / PEAK_FLOPS
        return ideal_s / self.bound_s if self.bound_s else 0.0

    def as_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_breakdown": self.collective_breakdown,
            "model_flops_global": self.model_flops_global,
            "bytes_per_device": self.bytes_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "bound_s": self.bound_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(n_params_active: float, tokens: float, kind: str) -> float:
    """6*N*D for training, 2*N*D for inference forward passes."""
    return (6.0 if kind == "train" else 2.0) * n_params_active * tokens


def terms_from_counts(
    arch: str, shape: str, mesh_name: str, n_devices: int,
    flops: float, nbytes: float, collective_bytes: Dict[str, int],
    model_flops_global: float, bytes_per_device: Optional[float] = None,
) -> RooflineTerms:
    """Terms from one device's counts: FLOPs, bytes accessed, and the
    operand bytes of each collective kind (:data:`COLLECTIVES`)."""
    breakdown = {k: int(collective_bytes.get(k, 0)) for k in COLLECTIVES}
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        hlo_flops=float(flops), hlo_bytes=float(nbytes),
        collective_bytes=float(sum(breakdown.values())),
        collective_breakdown=breakdown,
        model_flops_global=model_flops_global,
        bytes_per_device=bytes_per_device,
    )


def format_table(rows: List[RooflineTerms]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':9s} "
           f"{'compute_s':>10s} {'memory_s':>10s} {'collect_s':>10s} "
           f"{'dominant':>10s} {'useful':>7s} {'roofl%':>7s} {'GiB/dev':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        gib = (r.bytes_per_device or 0) / 2**30
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.mesh:9s} "
            f"{r.compute_s:10.4f} {r.memory_s:10.4f} {r.collective_s:10.4f} "
            f"{r.dominant:>10s} {r.useful_flops_ratio:7.3f} "
            f"{100*r.roofline_fraction:6.1f}% {gib:8.2f}")
    return "\n".join(lines)

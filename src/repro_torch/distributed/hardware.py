"""Target hardware constants (NVIDIA H100 SXM) for the perf model.

Every number is NVIDIA's public data sheet figure for the SXM part at
its full 700 W power limit — none is measured by this repository. A card
set below that limit runs slower; the measured numbers live in PERF.md.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "nvidia-h100-sxm"
    peak_flops_bf16: float = 989e12       # dense bf16 tensor-core FLOP/s
    hbm_bytes: float = 80e9               # device memory
    hbm_bw: float = 3.35e12               # bytes/s
    # Link between two instances: NVLink, 450 GB/s each way (900 GB/s
    # both ways, all to all inside one host).
    ici_link_bw: float = 450e9
    # Device <-> host-DRAM transfer bandwidth: PCIe Gen5 x16, 64 GB/s
    # each way.
    host_link_bw: float = 64e9

    @property
    def critical_intensity(self) -> float:
        """FLOP/byte where compute and HBM time are equal (~295 here)."""
        return self.peak_flops_bf16 / self.hbm_bw


H100 = HardwareSpec()

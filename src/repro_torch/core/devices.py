"""Simulated TPU device models (stand-ins for the paper's six GPUs).

The paper's benchmark hub spans six GPUs (A100, A4000, A6000, MI250X, W6600,
W7800) whose differing compute/bandwidth balances make kernel optima
device-dependent. This container is CPU-only, so the hub here spans six
*TPU-like device models* with the same kind of diversity: peak bf16 FLOP/s,
HBM bandwidth, VMEM capacity, MXU tile, and noise level differ per device.
The production target (v5e) is one of them.

These constants drive the analytical kernel cost model (costmodel.py) that
plays the role of hardware measurement when brute-forcing the hub dataset.

Port copy of ``src/repro/core/devices.py``
and kept as its own copy: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    peak_flops: float          # bf16 FLOP/s per chip
    hbm_bw: float              # bytes/s
    vmem_bytes: int            # per-core VMEM
    mxu: int                   # systolic array dim (matmul tile)
    sublane: int               # second-minor tiling (8 for fp32/bf16 rows)
    lane: int                  # minor tiling (128)
    ici_bw: float              # bytes/s per link
    noise_sigma: float         # log-normal measurement noise
    overhead_s: float          # per-launch framework overhead (seconds)
    compile_s: float           # per-config compile time (seconds)

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte at the compute/memory roofline ridge."""
        return self.peak_flops / self.hbm_bw


# Production target — TPU v5e (the roofline constants from the assignment).
V5E = DeviceModel("tpu_v5e", peak_flops=197e12, hbm_bw=819e9,
                  vmem_bytes=32 * 2**20, mxu=128, sublane=8, lane=128,
                  ici_bw=50e9, noise_sigma=0.03, overhead_s=40e-6, compile_s=0.9)

# Five additional models spanning the compute/bandwidth plane the way the
# paper's GPU set does (ratios chosen to move kernel optima around).
V4 = DeviceModel("tpu_v4", peak_flops=275e12, hbm_bw=1228e9,
                 vmem_bytes=32 * 2**20, mxu=128, sublane=8, lane=128,
                 ici_bw=100e9, noise_sigma=0.025, overhead_s=40e-6, compile_s=1.1)
V5P = DeviceModel("tpu_v5p", peak_flops=459e12, hbm_bw=2765e9,
                  vmem_bytes=48 * 2**20, mxu=128, sublane=8, lane=128,
                  ici_bw=200e9, noise_sigma=0.02, overhead_s=40e-6, compile_s=1.2)
V6E = DeviceModel("tpu_v6e", peak_flops=918e12, hbm_bw=1640e9,
                  vmem_bytes=48 * 2**20, mxu=256, sublane=8, lane=128,
                  ici_bw=90e9, noise_sigma=0.03, overhead_s=40e-6, compile_s=1.0)
LITE_A = DeviceModel("tpu_lite_a", peak_flops=91e12, hbm_bw=307e9,
                     vmem_bytes=16 * 2**20, mxu=128, sublane=8, lane=128,
                     ici_bw=25e9, noise_sigma=0.05, overhead_s=60e-6, compile_s=0.7)
LITE_B = DeviceModel("tpu_lite_b", peak_flops=45e12, hbm_bw=410e9,
                     vmem_bytes=16 * 2**20, mxu=128, sublane=8, lane=128,
                     ici_bw=25e9, noise_sigma=0.06, overhead_s=60e-6, compile_s=0.6)

HUB_DEVICES: tuple = (V5E, V4, V5P, V6E, LITE_A, LITE_B)
DEVICES_BY_NAME = {d.name: d for d in HUB_DEVICES}

# Train/test split mirroring the paper (Sec. IV-A): tuning happens on three
# devices, generalization is evaluated on the other three.
TRAIN_DEVICES = ("tpu_v5e", "tpu_v4", "tpu_lite_a")
TEST_DEVICES = ("tpu_v5p", "tpu_v6e", "tpu_lite_b")

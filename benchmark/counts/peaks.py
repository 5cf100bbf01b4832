"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
700 W limit) and the least time a piece of work can take on it."""
from __future__ import annotations

import subprocess

PEAK_BF16_FLOPS = 989e12          # tensor cores, bf16, dense
PEAK_FP32_FLOPS = 67e12           # FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12          # HBM3
SFU_PER_CLOCK_SM = 16             # special-function operations per clock, SM


def bytes_ms(n_bytes: float) -> float:
    return n_bytes / PEAK_HBM_BYTES * 1e3


def tensor_ms(flops: float) -> float:
    return flops / PEAK_BF16_FLOPS * 1e3


def max_sm_clock_mhz() -> float:
    """nvidia-smi's maximum SM clock of card 0, in MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


"""The card's published peaks and its name and power limit.

One copy for the port's tools and chip_smoke.py, so that a roofline share
and a bound are taken against the same peaks. The peaks are those of one
H100 SXM on NVIDIA's data sheet (dense, no sparsity, at its 700 W limit):
device memory rate, f32 FMA rate outside the tensor cores, dense bf16 rate
of the tensor cores.
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S, F32_FLOPS, BF16_TENSOR_FLOPS = 3.35e12, 67e12, 989e12
# card name (a substring of torch.cuda.get_device_name()) -> (dense bf16
# FLOP/s, memory bytes/s)
PEAKS = {"H100 80GB HBM3": (BF16_TENSOR_FLOPS, HBM_BYTES_PER_S)}


def card_peaks(device: torch.device):
    """(FLOP/s, bytes/s) of the card, or (None, None) off the table and on
    the CPU."""
    if device.type != "cuda":
        return None, None
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in PEAKS.items() if k in name), (None, None))


def card_text(index: int = 0) -> str:
    """Card `index`'s name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[index]
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(index)} (power limit not read)"

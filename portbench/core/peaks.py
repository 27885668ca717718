"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit) and the card's own name and limit."""

from __future__ import annotations

import subprocess

__all__ = ["F32_FLOPS", "HBM_BYTES", "least_seconds", "card"]

F32_FLOPS = 67e12    # float32 on the CUDA cores (TF32 stays off)
HBM_BYTES = 3.35e12  # HBM3 bytes a second


def least_seconds(work: dict) -> float:
    """The least time one unit of ``work`` (``flops``, ``bytes``) takes:
    the larger of its operations at the f32 peak and its bytes at the
    memory peak."""
    return max(work["flops"] / F32_FLOPS, work["bytes"] / HBM_BYTES)


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi gave nothing ({out.stderr.strip()[:200]})"

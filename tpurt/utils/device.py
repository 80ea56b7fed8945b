"""Which device a measurement ran on, and the guard that it is a GPU.

Every timing the repository prints names its device: JAX's platform,
device_kind and count, XLA_FLAGS, and the card's name and power limit as
nvidia-smi reports them (a card set below its maximum power runs slower
under load). nvidia-smi runs as a child process that stays off JAX.
"""
from __future__ import annotations

import os
import subprocess

# Published peaks per device_kind, dense rates (NVIDIA H100 SXM data sheet:
# 3.35 TB/s HBM3, 67 TFLOP/s f32 outside the tensor cores, 989 TFLOP/s
# bf16, 80 GB). A device that is not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12,
                                  f32_flops_per_s=67e12,
                                  bf16_flops_per_s=989e12,
                                  memory_bytes=80e9,
                                  source="NVIDIA H100 SXM data sheet"),
}


def card_info() -> str:
    """`name, power.limit` of every card, one per line, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu() -> dict:
    """Raise unless JAX's first device is a GPU; return what to print
    beside a measurement."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} "
                         f"({dev.device_kind}); this command measures the "
                         f"card and does not fall back to the CPU")
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()), jax=jax.__version__,
                xla_flags=os.environ.get("XLA_FLAGS", ""),
                card=card_info())


def peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"add it to tpurt.utils.device.PEAKS with its source")
    return PEAKS[device_kind]

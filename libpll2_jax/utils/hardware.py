"""Hardware probe — the device analog of the reference's cpuid detection.

Reference: /root/reference/src/hardware.c:25-189 (pll_hardware_probe fills
a struct consulted on every SIMD kernel dispatch). Under XLA there is no
runtime kernel dispatch to gate — the compiler targets the device — so the
probe reports the JAX device topology instead, and `dump` mirrors
pll_hardware_dump.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List


@dataclass
class HardwareInfo:
    platform: str
    device_kind: str
    device_count: int
    local_device_count: int
    process_count: int
    devices: List[str] = field(default_factory=list)


def probe() -> HardwareInfo:
    import jax
    devs = jax.devices()
    return HardwareInfo(
        platform=devs[0].platform if devs else "none",
        device_kind=devs[0].device_kind if devs else "none",
        device_count=jax.device_count(),
        local_device_count=jax.local_device_count(),
        process_count=jax.process_count(),
        devices=[str(d) for d in devs],
    )


def dump(file=None) -> HardwareInfo:
    """pll_hardware_dump analog."""
    info = probe()
    out = file or sys.stdout
    print(f"platform: {info.platform}", file=out)
    print(f"device kind: {info.device_kind}", file=out)
    print(f"devices: {info.device_count} "
          f"({info.local_device_count} local, "
          f"{info.process_count} processes)", file=out)
    return info


def card_info() -> str:
    """`name, power.limit` of each NVIDIA card as nvidia-smi reports them
    (one line per card), or "" where nvidia-smi is absent. Device times
    depend on the power limit, so every measurement is reported beside
    it."""
    import shutil
    import subprocess
    if shutil.which("nvidia-smi") is None:
        return ""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=30)
    return r.stdout.strip()

"""Which accelerator a measurement runs on.

A timing means something only beside the card it was taken on, so the
bench and the chip smoke test refuse to run off a GPU and print the
card's name and power limit (a card set below its maximum power runs
slower under load) next to every number they report.
"""

from __future__ import annotations

import subprocess
from typing import List, Optional, Tuple

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def require_gpu(devices=None) -> list:
    """Return the JAX devices when the first is a GPU; raise otherwise.
    There is no CPU fallback: a number taken on the CPU backend is not a
    device number."""
    if devices is None:
        import jax

        devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {d.platform!r} "
            f"({d.device_kind}); this measurement runs only on a GPU")
    return list(devices)


def parse_gpu_query(text: str) -> List[Tuple[str, Optional[float]]]:
    """Parse ``nvidia-smi --query-gpu=name,power.limit --format=csv,
    noheader`` output into ``[(name, power_limit_watts or None), ...]``,
    one entry per card. A limit nvidia-smi cannot read ("[N/A]") parses
    as None."""
    out = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        name, _, limit = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        num = limit.strip().split(" ")[0]
        try:
            watts = float(num)
        except ValueError:
            watts = None
        out.append((name.strip(), watts))
    return out


def query_gpus(timeout_s: float = 30.0) -> Tuple[str, list]:
    """Run nvidia-smi in a child process (it never imports JAX, so it
    takes no device memory) and return ``(raw text, parsed list)``."""
    r = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                       timeout=timeout_s, check=True)
    return r.stdout.strip(), parse_gpu_query(r.stdout)

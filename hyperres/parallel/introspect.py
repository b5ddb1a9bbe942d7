"""Compiled-HLO introspection: structural collective traffic.

Extracts the collective operations (all-reduce / all-gather /
collective-permute / reduce-scatter) and their output bytes from a
jitted program's compiled HLO — the traffic that rides the device
interconnect (NVLink between GPUs) on a real multi-device mesh. The
virtual-CPU mesh proves correctness and partitioning cost; the byte
counts bound the communication term that virtual devices cannot time. `scripts/bench_multichip_scaling.py`
uses the same extraction inline (it must run standalone pre-JAX-init).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

_DTYPE_BYTES = {"f32": 4, "f16": 2, "bf16": 2, "f64": 8, "s32": 4,
                "u32": 4, "s8": 1, "u8": 1, "pred": 1, "u16": 2,
                "s16": 2}

_COLL = re.compile(
    r"= (\w+)\[([\d,]*)\][^=]*?"
    r"(all-reduce|all-gather|collective-permute|reduce-scatter)")


def collective_bytes_from_text(hlo_text: str) -> Tuple[int, Dict[str, int]]:
    """(total output bytes, {op name: count}) of the collectives in a
    compiled HLO module text."""
    total, counts = 0, {}
    for dt, shape, op in _COLL.findall(hlo_text):
        elems = 1
        for d in shape.split(","):
            if d:
                elems *= int(d)
        total += elems * _DTYPE_BYTES.get(dt, 4)
        counts[op] = counts.get(op, 0) + 1
    return total, counts


def collective_bytes(jitted, *args) -> Tuple[int, Dict[str, int]]:
    """Lower+compile ``jitted`` for ``args`` and extract its structural
    collective traffic. ``args`` may be concrete arrays or
    ShapeDtypeStructs."""
    return collective_bytes_from_text(
        jitted.lower(*args).compile().as_text())

"""The state pass and workspace layout the two chunked scans share.

``csrc/ssd.cu`` and ``csrc/rwkv6.cu`` both run their middle pass
through ``state_pass`` in ``csrc/common.cuh`` and take one workspace
from their wrapper: the fp32 chunk states, then the incoming states (4
bytes an element either way: fp32, or bf16 high parts followed by bf16
low parts), then the fp32 chunk decays, each part aligned.
"""

from __future__ import annotations

__all__ = ["PASS_THREADS", "WS_ALIGN", "state_pass_blocks", "workspace"]

#: threads of a block of the state pass
PASS_THREADS = 256
#: byte alignment of each part of the workspace
WS_ALIGN = 256


def _align(n: int) -> int:
    return -(-n // WS_ALIGN) * WS_ALIGN


def state_pass_blocks(per_row: int, four: bool) -> int:
    """The state pass's blocks per (b, h) row of ``per_row`` state
    elements: four elements a thread where ``four`` (and the states are
    16-byte aligned, as fresh tensors are), else one."""
    per_thread = 4 if four else 1
    return -(-per_row // (per_thread * PASS_THREADS))


def workspace(states: int, decays: int) -> tuple:
    """``((chunk states, incoming states, decays), total)`` in bytes for
    ``states`` state elements over all chunks and ``decays`` decay
    factors."""
    delta = _align(4 * states)
    s_in = _align(4 * states)
    return (0, delta, delta + s_in), delta + s_in + _align(4 * decays)

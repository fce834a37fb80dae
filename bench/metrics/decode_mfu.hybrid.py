"""The whole decode step's share of the chip's roofline in a Mamba-2 /
attention pattern hybrid: for each step started in the window, the
least time the H100 could take for it (the larger of its useful
operations at 989 TFLOP/s and its bytes at 3.35 TB/s, counted by
``bench/cost_hybrid.py``: every weight read once, each active slot's SSM
and conv state read and written, its K/V over the valid positions),
summed, over the window's seconds, as ``decode_mfu.py`` reads a
decoder's.  Needs the traced run's per-step cache lengths."""

from bench.cost import roofline_s
from bench.cost_hybrid import decode_step_cost
from bench.readers import share, window_steps


def read(record):
    keys = record.get("step_keys")
    if not keys or not record["cfg"].get("attn_layer_ids"):
        return None
    total = 0.0
    for i, _, active in window_steps(record):
        if i >= len(keys):
            return None
        k = [n for n, a in zip(keys[i], active) if a]
        if k:
            total += roofline_s(*decode_step_cost(record["cfg"], k))[0]
    return share(total, record["seconds"])

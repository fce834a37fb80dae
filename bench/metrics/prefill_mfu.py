"""The whole prefill's share of the chip's peak: over the prefills
traced whole, their useful operations (every layer's projections and
FFN, an MoE token's top-k experts only, the causal attention products,
the last token's logits) over their device seconds at 989 TFLOP/s.
A prefill's device seconds are those of every operation launched from
inside its span."""

from bench.cost import PEAK_BF16_FLOPS, prefill_flops
from bench.readers import share, traced_spans


def read(record):
    spans = traced_spans(record, "prefill")
    flops = sum(prefill_flops(record["cfg"], int(f[1])) for f, _ in spans)
    dev = sum(sum(ops.values()) for _, ops in spans)
    return share(flops / PEAK_BF16_FLOPS, dev)

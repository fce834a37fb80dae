"""``kernels/csrc/decode_attention.cu`` against its roofline: over the
decode steps traced whole, the least time of each layer's call (every
slot's K and V over the keys it reads, the queries and outputs, at
3.35 TB/s, or its operations at 989 TFLOP/s if larger), summed, over
the device seconds of the split and merge kernels in those steps."""

from bench.cost import decode_attention_cost, roofline_s
from bench.readers import share, traced_spans

KERNELS = ("decode_split_kernel", "decode_merge_kernel")


def read(record):
    cfg, keys = record["cfg"], record.get("step_keys") or []
    bound = dev = 0.0
    for f, ops in traced_spans(record, "decode"):
        i = int(f[0])
        t = sum(ops.get(k, 0.0) for k in KERNELS)
        if t > 0 and i < len(keys):
            call = roofline_s(*decode_attention_cost(cfg, keys[i]))[0]
            bound += cfg["n_layers"] * call
            dev += t
    return share(bound, dev)

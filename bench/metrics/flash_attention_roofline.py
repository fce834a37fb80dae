"""``kernels/csrc/flash_attention.cu`` against its roofline: over the
prefills traced whole, the least time of each layer's causal attention
call (the larger of its operations at 989 TFLOP/s and q, k, v and the
output moved once at 3.35 TB/s), summed, over the device seconds of the
kernel's launches (``flash_mma_kernel``, ``flash_scalar_kernel``) in
those prefills."""

from bench.cost import flash_attention_cost, roofline_s
from bench.readers import share, traced_spans

KERNELS = ("flash_mma_kernel", "flash_scalar_kernel")


def read(record):
    cfg = record["cfg"]
    bound = dev = 0.0
    for f, ops in traced_spans(record, "prefill"):
        t = sum(ops.get(k, 0.0) for k in KERNELS)
        if t > 0:
            call = roofline_s(*flash_attention_cost(cfg, int(f[1])))[0]
            bound += cfg["n_layers"] * call
            dev += t
    return share(bound, dev)

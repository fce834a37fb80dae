"""``kernels/csrc/decode_attention.cu`` against its roofline in a Mamba-2
/ attention pattern hybrid: as ``decode_attention_roofline.py`` reads a
decoder's, over the decode steps traced whole, the least time of each
attention layer's call (every slot's K and V over the keys it reads,
the queries and outputs, at 3.35 TB/s, or its operations at 989 TFLOP/s
if larger) summed over the configuration's attention layers
(``attn_layer_ids``) alone, over the device seconds of the split and
merge kernels in those steps.  A configuration without the pattern
gives none."""

from bench.cost import decode_attention_cost, roofline_s
from bench.readers import share, traced_spans

KERNELS = ("decode_split_kernel", "decode_merge_kernel")


def read(record):
    cfg, keys = record["cfg"], record.get("step_keys") or []
    n_attn = len(cfg.get("attn_layer_ids") or ())
    if not n_attn:
        return None
    bound = dev = 0.0
    for f, ops in traced_spans(record, "decode"):
        i = int(f[0])
        t = sum(ops.get(k, 0.0) for k in KERNELS)
        if t > 0 and i < len(keys):
            bound += n_attn * roofline_s(*decode_attention_cost(cfg, keys[i]))[0]
            dev += t
    return share(bound, dev)

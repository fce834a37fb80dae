"""``kernels/csrc/ssd.cu``'s one-token kernel against its roofline: over
the decode steps traced whole, each Mamba layer's least time for its
call (every active slot's fp32 state read and written, its x, B, C and
dt read and y written, at 3.35 TB/s: ``bench/cost_hybrid.py``), summed,
over the device seconds of ``ssd_decode_kernel`` (a template: matched by
prefix) in those steps.  Needs the traced run's steps; a program or cell
without the kernel gives none."""

from bench.cost import roofline_s
from bench.cost_hybrid import ssd_decode_bytes
from bench.readers import share, traced_spans

KERNEL = "ssd_decode_kernel"


def read(record):
    cfg, steps = record["cfg"], record["steps"]
    if not cfg.get("ssm_state") or not cfg.get("attn_layer_ids"):
        return None
    n_mamba = cfg["n_layers"] - len(cfg["attn_layer_ids"])
    bound = dev = 0.0
    for f, ops in traced_spans(record, "decode"):
        i = int(f[0])
        t = sum(s for name, s in ops.items() if name.startswith(KERNEL))
        if t > 0 and i < len(steps):
            active = sum(steps[i][1])
            bound += n_mamba * roofline_s(0, ssd_decode_bytes(cfg, active))[0]
            dev += t
    return share(bound, dev)

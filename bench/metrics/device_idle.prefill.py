"""The H100's idle share in a traced stretch: the share of the traced
window in which no operation ran on the device (``torch.profiler``'s
device intervals, merged)."""

from bench.readers import share


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    return share(tr["window_s"] - tr["busy_s"], tr["window_s"])

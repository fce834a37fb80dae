"""Time to first token, 95th percentile over every request due in the
window: the first token's time minus the request's due time (host
clock), so a late generator or a stalled queue counts."""

from bench.readers import in_window, p95


def read(record):
    return p95([
        None if r["first_token"] is None else r["first_token"] - r["due"]
        for r in in_window(record)
    ])

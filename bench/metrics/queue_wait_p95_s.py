"""Ingestion wait, 95th percentile over the window's requests: the
moment a prefill worker took the request from the COREC ring and began
its prefill (the engine's ``_make_batch``) minus its due time."""

from bench.readers import in_window, p95


def read(record):
    return p95([
        None if r["prefill_start"] is None else r["prefill_start"] - r["due"]
        for r in in_window(record)
    ])

"""Every token the engine generated in the window over the window's
seconds: each decode step started in it gives one token per slot that
holds a request, each prefill finished in it the request's first."""

from bench.readers import window_steps


def read(record):
    t0, t1 = record["window"]
    decoded = sum(sum(a) for _, _, a in window_steps(record))
    first = sum(
        1
        for r in record["requests"]
        if r["first_token"] is not None and t0 <= r["first_token"] < t1
    )
    return (decoded + first) / record["seconds"]

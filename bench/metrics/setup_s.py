"""Process start to the first timed request's due time: imports,
kernel build or load, weights, the engine and its cache, the warm-up
(and a closed loop's ramp)."""


def read(record):
    return record["setup_s"]

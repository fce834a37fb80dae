"""``queue_wait_p95_s`` in a cell that reports ``tokens_per_s`` and no TTFT (a
closed loop, where a slower prefill leaves slots idle): the same
reading as ``bench/metrics/queue_wait_p95_s.py``."""

from bench.spec import BENCH, load_module

read = load_module(BENCH / "metrics" / "queue_wait_p95_s.py").read

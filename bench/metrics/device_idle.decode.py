"""The H100's idle share in the traced stretch of a decode-led cell:
the same reading as ``bench/metrics/device_idle.prefill.py``."""

from bench.spec import BENCH, load_module

read = load_module(BENCH / "metrics" / "device_idle.prefill.py").read

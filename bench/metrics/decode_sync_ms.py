"""Host milliseconds a decode step waits on its tokens: the program's
``readback`` span around ``argmax(...).tolist()``, which returns once
the device has run what the step enqueued, so it reads what the device
still had to run when the host finished enqueuing; averaged over the
window's whole steps, as ``bench/metrics/decode_enqueue_ms.py`` reads
the ``decode`` span."""

from bench.spec import BENCH, load_module

_step_ms = load_module(BENCH / "metrics" / "decode_enqueue_ms.py").step_ms


def read(record):
    return _step_ms(record, {"readback"})

"""Host milliseconds a decode step spends enqueuing its Mamba-2 layers:
the program's ``mamba`` spans (one a Mamba layer: its norm and mixer),
summed over the layers and averaged over the window's whole steps, as
``bench/metrics/decode_enqueue_ms.py`` reads the ``decode`` span."""

from bench.spec import BENCH, load_module

_step_ms = load_module(BENCH / "metrics" / "decode_enqueue_ms.py").step_ms


def read(record):
    return _step_ms(record, {"mamba"})

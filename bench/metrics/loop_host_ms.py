"""Host milliseconds of a decode step's own loop around the model: the
program's ``admit`` (staged caches copied into their slots), ``upload``
(the last tokens to the device) and ``retire`` (the finished sequences)
spans, summed and averaged over the window's whole steps, as
``bench/metrics/decode_enqueue_ms.py`` reads the ``decode`` span."""

from bench.spec import BENCH, load_module

_step_ms = load_module(BENCH / "metrics" / "decode_enqueue_ms.py").step_ms


def read(record):
    return _step_ms(record, {"admit", "upload", "retire"})

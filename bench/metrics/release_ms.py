"""Host milliseconds a decode step spends in the TAIL release: the
program's ``release`` span (the done-prefix launch over the pinned ring
state, the wait on its event, the tails' advance), averaged over the
window's whole steps, as ``bench/metrics/decode_enqueue_ms.py`` reads
the ``decode`` span."""

from bench.spec import BENCH, load_module

_step_ms = load_module(BENCH / "metrics" / "decode_enqueue_ms.py").step_ms


def read(record):
    return _step_ms(record, {"release"})

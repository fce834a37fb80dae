"""``correct`` has to come out false where the timed path is broken, and
the fp8 control has to fail each cell's limits.

On the CPU, whole runs of each cell on its tiny configuration, the
run's look for a chip skipped, with the decode step of the port's
model class that serves the cell broken underneath in each way a
serving cell can break: a step that returns its state unchanged, half
of the batch left out, a token altered where it is produced.  (The
exchange between chips has no place in a cell on one chip.)  On the
card (``cuda`` marker, skipped here), the control at each cell's own
size on three seeds::

    PYTHONPATH=src python -m pytest -q -m cuda bench/test_bench_faults.py
"""

from __future__ import annotations

import json

import pytest
import torch

from bench import control, spec
from bench.testing import TINY_SECONDS, tiny_cell

BENCH = spec.entries()  # BENCHMARK.json's cells and the parked ones
CELLS = [w["name"] for w in BENCH["workloads"]]


def _unchanged(step):
    def fault(self, params, cache, tokens, rules=None):
        n = cache["lengths"]
        kept = {k: t.clone() for k, t in cache.items() if k != "lengths"}
        _, logits = step(self, params, cache, tokens, rules)
        for k, t in kept.items():  # every state the step wrote, put back
            cache[k].copy_(t)
        return dict(cache, lengths=n), logits

    return fault


def _half_batch(step):
    def fault(self, params, cache, tokens, rules=None):
        cache, logits = step(self, params, cache, tokens, rules)
        B = logits.shape[0]
        out = logits.clone()
        out[B // 2 :] = logits[: B - B // 2]  # the second half never computed
        return cache, out

    return fault


def _token_altered(step):
    def fault(self, params, cache, tokens, rules=None):
        cache, logits = step(self, params, cache, tokens, rules)
        return cache, torch.roll(logits, 1, dims=-1)  # each token one id off

    return fault


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


def model_class(config: dict):
    """The port's model class that serves ``config``: the one a fault
    breaks."""
    from repro_torch.config import ArchConfig
    from repro_torch.models.api import build_model

    return type(build_model(ArchConfig(**config["config"])))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_decode_step_is_not_correct(name, fault, monkeypatch):
    _, cell, config = tiny_cell(name)
    model = model_class(config)
    monkeypatch.setattr(model, "decode_step", FAULTS[fault](model.decode_step))
    cell["check"]["sample"] = 32  # a fault may spare some slots: judge many answers
    driver = spec.load_driver(cell)
    rec = driver.run(cell, config, 2**31 + 9, TINY_SECONDS, False, device="cpu")
    assert rec["failed"] == 0  # every answer came, with its length
    assert rec["correct"] is False
    bad = [k for k, c in rec["checks"].items() if c["value"] > c["limit"]]
    assert set(bad) <= set(cell["check"]["limits"]) and bad


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_program_at_tiny_size(name, monkeypatch):
    monkeypatch.setattr(spec, "load_cell", tiny_cell)
    r = control.control_readings(name, 3, TINY_SECONDS, device="cpu")
    assert r["program_correct"] is True
    assert r["control"]["logit_gap"] > r["program"]["logit_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_cell_limits_on_the_card(name):
    """The fp8 control at the cell's own size and load, three seeds, in
    windows long enough that closed-loop requests come due in them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (101, 2**31 + 102, 3_000_000_103):
        r = control.control_readings(name, seed, 30.0)
        print(json.dumps(r))
        assert r["program_correct"] is True, r
        assert r["control_passes"] is False, r

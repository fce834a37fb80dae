"""The port's data pipeline (``repro_torch.data``, its own copy over its
own ``core/ring.py``): mirrors of ``tests/test_data.py``, and the batch
draw against the JAX package's ``SyntheticLMSource`` number for number
(the trainer's crash-and-resume comparison rests on it)."""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

from repro_torch.data import CorecDataPipeline, SyntheticLMSource, make_batches


@pytest.mark.parametrize("seed,index", [(0, 0), (3, 17), (5, 2**20 + 3)])
def test_source_equals_reference(seed, index):
    from repro.data import SyntheticLMSource as RefSource

    mine = SyntheticLMSource(vocab=151936, batch=3, seq=9, seed=seed).batch_at(index)
    ref = RefSource(vocab=151936, batch=3, seq=9, seed=seed).batch_at(index)
    assert mine["index"] == ref["index"] == index
    for k in ("tokens", "labels"):
        assert mine[k].dtype == ref[k].dtype == np.int32
        np.testing.assert_array_equal(mine[k], ref[k])


def test_make_batches_walks_indices():
    s = SyntheticLMSource(vocab=100, batch=2, seq=4, seed=1)
    got = list(make_batches(s, 5, 3))
    assert [b["index"] for b in got] == [5, 6, 7]
    np.testing.assert_array_equal(got[1]["tokens"], s.batch_at(6)["tokens"])


# ----------------------------------------------------------------------
# mirrors of tests/test_data.py
# ----------------------------------------------------------------------
def test_source_deterministic():
    s = SyntheticLMSource(vocab=100, batch=2, seq=8, seed=3)
    a = s.batch_at(17)
    b = s.batch_at(17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(s.batch_at(18)["tokens"], a["tokens"])


def test_labels_are_shifted_tokens():
    s = SyntheticLMSource(vocab=100, batch=1, seq=8, seed=0)
    b = s.batch_at(0)
    np.testing.assert_array_equal(b["tokens"][0, 1:], b["labels"][0, :-1])


def test_pipeline_delivers_in_order_single_feeder():
    src = SyntheticLMSource(vocab=50, batch=1, seq=4, seed=1)
    pipe = CorecDataPipeline(src, ring_size=64, n_producers=2)
    pipe.start()
    try:
        got = [pipe.next_batch()["index"] for _ in range(20)]
    finally:
        pipe.stop()
    assert got == list(range(20))


def test_pipeline_resume_position():
    """The released TAIL is a valid resume point: batch streams glue."""
    src = SyntheticLMSource(vocab=50, batch=1, seq=4, seed=2)
    pipe = CorecDataPipeline(src, ring_size=64, n_producers=2)
    pipe.start()
    try:
        seen = [pipe.next_batch()["index"] for _ in range(7)]
    finally:
        pipe.stop()
    pos = pipe.position()
    assert pos >= 7  # everything claimed AND released counts
    pipe2 = CorecDataPipeline.restore(src, pos, ring_size=64, n_producers=2)
    pipe2.start()
    try:
        nxt = pipe2.next_batch()["index"]
    finally:
        pipe2.stop()
    assert nxt == pos
    assert set(range(7)) <= set(seen)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(5, 30))
def test_pipeline_no_loss_no_dup(n):
    src = SyntheticLMSource(vocab=50, batch=1, seq=4, seed=4)
    pipe = CorecDataPipeline(src, ring_size=64, n_producers=3)
    pipe.start()
    try:
        got = [pipe.next_batch()["index"] for _ in range(n)]
    finally:
        pipe.stop()
    assert got == sorted(set(got)) == list(range(n))

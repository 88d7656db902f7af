"""The traffic generator: seeded, shaped as the mix says."""
import numpy as np
import pytest

from portbench.traffic import Traffic
from portbench.tests.support import traffic_of

BIG = 2 ** 31 + 987_654_321  # seeds may exceed 32 signed bits


@pytest.mark.parametrize("mix,vocab", [("gpt.b8s1024", 50257),
                                       ("mlm.b16s512", 30522),
                                       ("mlm.b64s128", 30522)])
def test_same_seed_same_batches_other_seed_other(mix, vocab):
    spec = traffic_of(mix)
    a, b, c = (Traffic(spec, vocab, s) for s in (BIG, BIG, BIG + 1))
    for step in (0, 1, 57):
        for x, y in zip(a.batch(step), b.batch(step)):
            np.testing.assert_array_equal(x, y)
        assert not np.array_equal(a.batch(step)[0], c.batch(step)[0])
    assert not np.array_equal(a.batch(0)[0], a.batch(1)[0])


@pytest.mark.parametrize("mix,vocab", [("gpt.b8s1024", 50257),
                                       ("mlm.b64s128", 30522)])
def test_shapes_and_mask(mix, vocab):
    spec = traffic_of(mix)
    batch = Traffic(spec, vocab, 3).batch(0)
    ids = batch[0]
    assert ids.shape == (spec["batch_size"], spec["seq_len"])
    assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < vocab
    if spec.get("mask_rate"):
        (_, mask) = batch
        per_row = mask.sum(axis=1)
        assert (per_row == round(spec["mask_rate"] * spec["seq_len"])).all()
    else:
        assert len(batch) == 1


def test_zipf_law_of_ranks():
    spec = dict(traffic_of("gpt.b8s1024"), batch_size=64)
    t = Traffic(spec, 50257, 5)
    ids = np.concatenate([t.batch(s)[0].ravel() for s in range(4)])
    counts = np.bincount(ids, minlength=50257)
    top = t.ids_of_rank[:3]
    harmonic = np.sum(1.0 / np.arange(1, 50258))
    share = counts[top] / ids.size
    np.testing.assert_allclose(share, [1 / harmonic, 0.5 / harmonic,
                                       1 / 3 / harmonic], rtol=0.05)

"""The port's data pipeline (``data/pipeline.py``, NumPy only) against the
JAX package's: the same batches, byte for byte, at several steps, sharded
over two hosts and read from a byte corpus; the same request stream and
bursty arrival times."""
import itertools

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("kw", [
    dict(vocab_size=512, seq_len=64, global_batch=4),
    dict(vocab_size=151_936, seq_len=256, global_batch=2, seed=7,
         mean_doc_len=32, eos_id=3),
    dict(vocab_size=512, seq_len=32, global_batch=4, host_count=2,
         host_index=0),
    dict(vocab_size=512, seq_len=32, global_batch=4, host_count=2,
         host_index=1),
])
def test_token_stream_batches_are_the_references(kw):
    t = tpipe.TokenStream(tpipe.DataConfig(**kw))
    j = jpipe.TokenStream(jpipe.DataConfig(**kw))
    assert t.local_batch == j.local_batch
    for step in (0, 1, 17):
        b = t.batch(step)
        _equal(b, j.batch(step))
        assert b["tokens"].shape == (t.local_batch, kw["seq_len"])
        assert (b["mask"] == (b["tokens"] != t.dc.eos_id)).all()
    for got, want in zip(itertools.islice(iter(t), 3),
                         itertools.islice(iter(j), 3)):
        _equal(got, want)


def test_hosts_read_disjoint_rows():
    kw = dict(vocab_size=512, seq_len=32, global_batch=4)
    whole = tpipe.TokenStream(tpipe.DataConfig(**kw)).batch(2)["tokens"]
    halves = [tpipe.TokenStream(tpipe.DataConfig(
        **kw, host_count=2, host_index=i)).batch(2)["tokens"]
        for i in range(2)]
    assert np.array_equal(np.concatenate(halves), whole)


def test_corpus_batches_are_the_references(tmp_path):
    path = tmp_path / "corpus.bin"
    path.write_bytes(np.random.default_rng(0).integers(
        0, 256, 5000, dtype=np.uint8).tobytes())
    kw = dict(vocab_size=200, seq_len=48, global_batch=3,
              corpus_path=str(path))
    t = tpipe.TokenStream(tpipe.DataConfig(**kw))
    j = jpipe.TokenStream(jpipe.DataConfig(**kw))
    for step in (0, 5):
        b = t.batch(step)
        _equal(b, j.batch(step))
        assert b["tokens"].max() < 200


def test_request_stream_is_the_references():
    dc = dict(vocab_size=1000, seq_len=300, global_batch=1)
    t = tpipe.make_request_stream(tpipe.DataConfig(**dc), mean_prompt=64,
                                  seed=3)
    j = jpipe.make_request_stream(jpipe.DataConfig(**dc), mean_prompt=64,
                                  seed=3)
    for a, b in zip(itertools.islice(t, 50), itertools.islice(j, 50)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert 4 <= len(a) <= 300


@pytest.mark.parametrize("kw", [dict(), dict(burst_factor=8.0, period_s=5.0,
                                             seed=2)])
def test_bursty_arrival_times_are_the_references(kw):
    t = tpipe.bursty_arrival_times(50.0, 30.0, **kw)
    j = jpipe.bursty_arrival_times(50.0, 30.0, **kw)
    assert t.tobytes() == j.tobytes()
    assert len(t) > 0 and (np.diff(t) >= 0).all()

"""The port's LM token pipeline (``repro_torch.data.lm_data``) against the
JAX package's: the same seeds give the same tokens, shard offsets, packed
index and batches, exactly, and the prefetch iterator yields them all."""

import numpy as np
import pytest

from repro.data import lm_data as R

from repro_torch.data import lm_data as T


@pytest.mark.parametrize("vocab,length,seed", [(512, 20_000, 3), (151_936, 50_001, 0),
                                               (97, 1_001, 7)])
def test_token_stream_equals_the_reference(vocab, length, seed):
    got, want = T.TokenStream(vocab, length, seed), R.TokenStream(vocab, length, seed)
    assert len(got) == len(want) == length
    assert got.tokens.dtype == want.tokens.dtype == np.int32
    assert np.array_equal(got.tokens, want.tokens)
    assert got.tokens.max() < vocab


@pytest.mark.parametrize("batch,seq_len,n_hosts,host_id,seed", [
    (4, 64, 1, 0, 3), (3, 50, 2, 1, 5), (8, 32, 4, 2, 0)])
def test_loader_equals_the_reference(batch, seq_len, n_hosts, host_id, seed):
    stream_t = T.TokenStream(512, 30_000, seed)
    stream_r = R.TokenStream(512, 30_000, seed)
    got = T.ShardedBatchLoader(stream_t, batch, seq_len, n_hosts, host_id, seed)
    want = R.ShardedBatchLoader(stream_r, batch, seq_len, n_hosts, host_id, seed)
    assert got.n_batches == want.n_batches > 1
    assert np.array_equal(got.offsets(), want.offsets())
    assert got.compressed_index_bytes == want.compressed_index_bytes
    for k, v in want._packed.items():
        if isinstance(v, np.ndarray):
            assert got._packed[k].tobytes() == v.tobytes(), k
        else:
            assert got._packed[k] == v, k
    # every batch of an epoch, then the wrap into the next
    for step in [*range(want.n_batches), want.n_batches, 2 * want.n_batches + 1]:
        g, w = got.batch_at(step), want.batch_at(step)
        assert g.keys() == w.keys() == {"tokens", "labels"}
        for k in w:
            assert g[k].dtype == np.int32 and np.array_equal(g[k], w[k]), (step, k)


def test_loader_deterministic_and_compressed():
    """``test_data_pipelines.py::test_lm_loader_deterministic_and_compressed``
    on the port."""
    stream = T.TokenStream(vocab=512, length=20_000, seed=3)
    loader = T.ShardedBatchLoader(stream, batch=4, seq_len=64, seed=3)
    b1 = loader.batch_at(2)
    b2 = loader.batch_at(2)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 64)
    # labels are next-token shifted
    assert np.array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    assert loader.compressed_index_bytes < loader.offsets().size * 8


def test_prefetch_iterator_yields_every_batch_in_order():
    stream = T.TokenStream(vocab=128, length=10_000, seed=0)
    loader = T.ShardedBatchLoader(stream, batch=2, seq_len=32, seed=0, prefetch=2)
    batches = list(loader)
    assert len(batches) == loader.n_batches
    ref = list(R.ShardedBatchLoader(R.TokenStream(128, 10_000, 0), 2, 32, seed=0,
                                    prefetch=2))
    assert len(ref) == len(batches)
    for s, (g, w) in enumerate(zip(batches, ref)):
        assert np.array_equal(g["tokens"], w["tokens"])
        assert np.array_equal(g["labels"], loader.batch_at(s)["labels"])

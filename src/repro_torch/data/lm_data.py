"""Synthetic LM token pipeline with an OptVB-compressed shard index.

Counterpart of ``repro/data/lm_data.py``: the same numpy draws in the same
order, so a seed gives the reference's tokens, offsets and batches bit for
bit.  A "corpus" is a long synthetic token stream (Zipfian unigram
distribution -- enough to exercise the training loop; no external data).
The *shuffle index* -- the sorted list of sample offsets assigned to each
host for each epoch -- is exactly the kind of sorted integer sequence the
paper's codec compresses; it is stored optimally-partitioned
(``checkpoint.pack_sorted_int_array``) and decoded whole on every
``batch_at``, as the reference does.

The loader's iterator prefetches ``prefetch`` batches on a background
thread (straggler mitigation: a slow I/O burst does not stall the step).
Batches are numpy arrays on the host; the launcher uploads them.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from ..checkpoint import pack_sorted_int_array, unpack_sorted_int_array


class TokenStream:
    def __init__(self, vocab: int, length: int, seed: int = 0, zipf_a: float = 1.3):
        rng = np.random.default_rng(seed)
        raw = rng.zipf(zipf_a, size=length)
        self.tokens = (raw % vocab).astype(np.int32)
        self.vocab = vocab

    def __len__(self) -> int:
        return self.tokens.size


class ShardedBatchLoader:
    """Deterministic, resumable-by-step batch loader.

    Sample offsets for an epoch are a strictly increasing sequence
    (sorted sample starts); stored OptVB-packed per host shard.
    """

    def __init__(
        self,
        stream: TokenStream,
        batch: int,
        seq_len: int,
        n_hosts: int = 1,
        host_id: int = 0,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.stream = stream
        self.batch = batch
        self.seq_len = seq_len
        n_samples = (len(stream) - 1) // seq_len
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n_samples)
        shard = np.sort(perm[host_id::n_hosts]) * seq_len  # sorted offsets
        # the paper's codec compresses the shard index
        self._packed = pack_sorted_int_array(shard.astype(np.int64) + 1)
        self.n_batches = shard.size // batch
        self.prefetch = prefetch

    @property
    def compressed_index_bytes(self) -> int:
        return int(self._packed["payload"].size + 8 * len(self._packed["endpoints"]))

    def offsets(self) -> np.ndarray:
        return unpack_sorted_int_array(self._packed) - 1

    def batch_at(self, step: int) -> dict:
        offs = self.offsets()
        sel = offs[(step % self.n_batches) * self.batch : (step % self.n_batches + 1) * self.batch]
        toks = np.stack([self.stream.tokens[o : o + self.seq_len + 1] for o in sel])
        return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            for step in range(self.n_batches):
                q.put(self.batch_at(step))
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                return
            yield item

"""The benchmark's inputs, made from the seed: posting lists, term
frequencies and queries.

The lists and frequencies are drawn in torch, on the card where there is
one, from a ``torch.Generator`` in a few large calls; the queries come
from numpy (``make_queries``, a copy of the program's
``repro_torch.data.postings.make_queries``).  The laws are the program's
generator's (``repro_torch.data.postings``), with two deliberate
differences for docIDs, so that the lists look like a collection's:

* the dense/sparse chain is the one its parameters describe: a dense gap
  is followed by a dense one with probability ``p_stay``, and a sparse gap
  by a sparse one with the probability that makes ``frac_dense`` of the
  gaps dense (the program's chain sends a sparse state back to dense after
  about one step, so about 0.1% of its gaps are sparse);
* every list lies in a universe of ``documents`` docIDs: a list of n
  postings has a mean gap of documents / n, its sparse gaps' mean set to
  fill that, its sparse gaps shrunk where a draw overruns the universe,
  and its first docID placed at random in the room left.

Term frequencies follow the program's hot/cold chain as it is.
"""

from __future__ import annotations

import numpy as np


def make_queries(rng, n_lists, n_queries=50, arity=2):
    """Random conjunctive queries (term id tuples)."""
    return [
        list(rng.choice(n_lists, size=arity, replace=False))
        for _ in range(n_queries)
    ]


def torch_generator(seed: int, device):
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` (any
    non-negative whole number; reduced to 64 bits)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def zipf_torch(g, a: float, n: int, device):
    """n draws of numpy's Zipf(a) by its own rejection rule, int64."""
    import torch

    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        u = 1.0 - torch.rand(m, dtype=torch.float64, device=device, generator=g)
        v = torch.rand(m, dtype=torch.float64, device=device, generator=g)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = ((x >= 1.0) & (x < 2.0 ** 63)
              & (v * x * (t - 1.0) / (b - 1.0) <= t / b))
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out.to(torch.int64)


def _list_starts(lens, device):
    import torch

    offs = torch.zeros(len(lens) + 1, dtype=torch.int64, device=device)
    offs[1:] = torch.cumsum(torch.as_tensor(lens, device=device), 0)
    return offs


def other_stay(p_stay: float, share: float) -> float:
    """The chance that the other state of a two-state chain stays, where
    this one stays with ``p_stay`` and holds ``share`` of the steps: 1 -
    (1 - p_stay) * share / (1 - share), in [0.5, 0.99999], as the
    program's generator works it out."""
    stay = 1.0 - (1.0 - p_stay) * share / max(1e-9, 1.0 - share)
    return min(max(stay, 0.5), 0.99999)


def chain_states(u, s0, offs, p_stay: float, share: float):
    """The states of one two-state chain a list: state i + 1 is on where
    state i is on and ``u[i] < p_stay``, or where it is off and ``u[i] >=
    other_stay(p_stay, share)``; a list's first
    state is its ``s0``.  Solved by ``cummax`` and ``cumsum``: a step
    whose two branches agree sets the next state, one where they differ
    flips it."""
    import torch

    n = u.numel()
    a = u < p_stay
    b = u >= other_stay(p_stay, share)
    starts = offs[:-1]
    idx = torch.arange(n, device=u.device)
    flips = torch.zeros(n + 1, dtype=torch.int64, device=u.device)
    flips[1:] = torch.cumsum(b & ~a, 0)
    known = torch.zeros(n, dtype=torch.bool, device=u.device)
    known[1:] = (a == b)[:-1]
    value = torch.zeros(n, dtype=torch.bool, device=u.device)
    value[1:] = a[:-1]
    # a list's first state is known; an empty list marks nothing
    open_ = starts[starts < offs[1:]]
    known[open_] = True
    value[open_] = s0[starts < offs[1:]]
    del a, b
    last = torch.cummax(torch.where(known, idx, torch.zeros_like(idx)),
                        0).values
    return value[last] ^ ((flips[idx] - flips[last]) & 1).bool()


def _geometric(g, p, device):
    """Geometric draws (support 1, 2, ...) of success chance ``p``, one a
    element of the float64 tensor ``p``, by the inverse of the law."""
    import torch

    v = torch.rand(p.numel(), dtype=torch.float64, device=device, generator=g)
    out = torch.floor(torch.log1p(-v) / torch.log1p(-p.clamp(max=1 - 1e-12)))
    return out.to(torch.int64) + 1


def make_corpus_torch(seed, device, lens, documents, mean_dense_gap=1.3,
                      p_stay=0.999, frac_dense=0.85):
    """(docIDs [N] int64 on ``device``, offsets [n_lists + 1] int64): lists
    of the lengths ``lens`` in ``[0, documents)``, list l at
    ``docs[offs[l]:offs[l+1]]``, strictly increasing.  ``frac_dense`` of
    the gaps are dense (Geometric of mean ``mean_dense_gap``) in runs of
    mean ``1 / (1 - p_stay)``; the sparse gaps are Geometric of the mean
    that gives the list a mean gap of ``documents / n``."""
    import torch

    g = torch_generator(seed, device)
    n_lists = len(lens)
    lens = torch.as_tensor(np.asarray(lens, np.int64), device=device)
    if int(lens.min()) < 1:
        raise ValueError("every list holds a posting")
    offs = _list_starts(lens, device)
    n = int(offs[-1])
    of = torch.repeat_interleave(torch.arange(n_lists, device=device), lens)
    u = torch.rand(n, dtype=torch.float64, device=device, generator=g)
    s0 = torch.rand(n_lists, dtype=torch.float64, device=device,
                    generator=g) < frac_dense
    dense = chain_states(u, s0, offs, p_stay, frac_dense)
    del u
    want = documents / lens.to(torch.float64)
    sparse_mean = ((want - frac_dense * mean_dense_gap)
                   / (1.0 - frac_dense)).clamp(min=1.0)
    gd = torch.empty(n, dtype=torch.float64, device=device).geometric_(
        min(1.0, 1.0 / mean_dense_gap), generator=g).to(torch.int64)
    gs = _geometric(g, (1.0 / sparse_mean)[of], device)
    gaps = torch.where(dense, gd, gs)
    del gd, gs

    def per_list(x):
        return torch.zeros(n_lists, dtype=x.dtype, device=device).index_add_(
            0, of, x)

    # shrink a list's sparse gaps (each keeps at least 1) where the draw
    # overruns the universe
    span = per_list(gaps)
    dense_sum = per_list(torch.where(dense, gaps, 0))
    n_sparse = per_list((~dense).to(torch.int64))
    room = documents - dense_sum - n_sparse
    if bool((room < 0).any()):
        raise ValueError(f"lists of up to {int(lens.max()):,} postings do "
                         f"not fit {documents:,} documents")
    excess = (span - dense_sum - n_sparse).to(torch.float64)
    # (a hair under the exact ratio, so that no product rounds up)
    shrink = torch.where(span > documents, room.to(torch.float64)
                         / excess.clamp(min=1.0) * (1.0 - 1e-12), 1.0)
    shrunk = 1 + torch.floor((gaps - 1).to(torch.float64) * shrink[of]).to(
        torch.int64)
    gaps = torch.where(dense, gaps, shrunk)
    del shrunk, dense
    span = per_list(gaps)
    # the first docID anywhere in the room the list leaves
    w = torch.rand(n_lists, dtype=torch.float64, device=device, generator=g)
    start = torch.floor(w * (documents - span + 1).to(torch.float64)).to(
        torch.int64)
    docs = torch.cumsum(gaps, 0)
    del gaps
    before = torch.zeros(n_lists, dtype=torch.int64, device=device)
    before[1:] = docs[offs[1:-1] - 1]
    docs += torch.repeat_interleave(start - before, lens) - 1
    if int(docs[offs[1:] - 1].max()) >= documents:
        raise AssertionError("a docID outside the universe")
    return docs, offs


def make_freqs_torch(seed, offs, device, zipf_hot=1.25, zipf_cold=3.0,
                     p_stay=0.995, frac_hot=0.15, max_tf=4096):
    """tf >= 1 [N] int64 on ``device`` of the program's ``make_freqs`` law
    (a sticky hot/cold chain of Zipf draws) for the lists at ``offs``, from
    a stream of its own of ``seed``."""
    import torch

    g = torch_generator(int(seed) * 2 + 1, device)
    n = int(offs[-1])
    n_lists = len(offs) - 1
    u = torch.rand(n, dtype=torch.float64, device=device, generator=g)
    s0 = torch.rand(n_lists, dtype=torch.float64, device=device,
                    generator=g) < frac_hot
    hot = chain_states(u, s0, offs, p_stay, frac_hot)
    del u
    tf = torch.where(hot, zipf_torch(g, zipf_hot, n, device),
                     zipf_torch(g, zipf_cold, n, device))
    return tf.clamp(max=max_tf)


def split(flat: np.ndarray, offs: np.ndarray) -> list[np.ndarray]:
    """Views of ``flat`` per list."""
    return [flat[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]


def config_lengths(cfg: dict) -> np.ndarray:
    """The configuration's list lengths by rank: Zipf(``zipf_a``) draws
    from its ``sizes_seed`` times ``min_len``, clipped to ``[min_len,
    max_len]`` (the program's ``make_corpus`` law)."""
    rng = np.random.default_rng(cfg["sizes_seed"])
    raw = rng.zipf(cfg["zipf_a"], size=cfg["n_lists"]).astype(np.float64)
    return np.clip((cfg["min_len"] * raw).astype(np.int64), cfg["min_len"],
                   cfg["max_len"])


def list_lengths(cfg: dict, seed: int) -> np.ndarray:
    """The list lengths of a run: the configuration's, dealt to the list
    ids in an order drawn from ``seed``.  Every seed gets the same sizes,
    so the same postings, in another order."""
    return config_lengths(cfg)[_placement(cfg, seed)]


def _placement(cfg: dict, seed: int) -> np.ndarray:
    """perm: list id i holds the configuration's list of rank perm[i]."""
    return np.random.default_rng([int(seed), 4]).permutation(cfg["n_lists"])


def make_inputs(seed: int, cfg: dict, device=None):
    """(lists, freqs or None): host int64 arrays, one per list, of the
    lengths ``list_lengths`` gives, made from ``seed`` on ``device`` by the
    laws of the configuration's ``postings`` section; freqs where its
    ``freqs`` is true."""
    lens = list_lengths(cfg, seed)
    docs, offs = make_corpus_torch(seed, device, lens, **cfg["postings"])
    offs_h = offs.cpu().numpy()
    lists = split(docs.cpu().numpy(), offs_h)
    if not cfg["freqs"]:
        return lists, None
    tf = make_freqs_torch(seed, offs, device)
    return lists, split(tf.cpu().numpy(), offs_h)


def query_pool(seed: int, cfg: dict, n: int, arity: int) -> list[list[int]]:
    """The window's ``n`` queries of ``arity`` distinct terms, in the order
    the seed draws.  The set is one a configuration: ``make_queries``'
    draw over its lists by rank, uniform, from its ``sizes_seed``; a seed
    changes which list holds which rank, the lists' contents and the order
    the queries are sent in, not the queries' sizes."""
    ranks = np.asarray(make_queries(np.random.default_rng(
        [cfg["sizes_seed"], 1]), cfg["n_lists"], n, arity), np.int64)
    order = np.random.default_rng([int(seed), 1]).permutation(n)
    to_id = np.argsort(_placement(cfg, seed))
    return [[int(t) for t in to_id[ranks[i]]] for i in order]


def warm_pool(seed: int, n_lists: int, n: int, arity: int) -> list[list[int]]:
    """``n`` warm-up queries, uniform over the lists, from a stream of
    ``seed`` the window's queries are not drawn from."""
    rng = np.random.default_rng([int(seed), 3])
    return [[int(t) for t in q] for q in make_queries(rng, n_lists, n, arity)]

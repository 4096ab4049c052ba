"""The port's Table 6 space models (``repro_torch.core.competitors``) give
the reference's integers exactly: each model on the same seeded
sequences, the edge cases among them (empty, singleton, dense runs, a
universe past 2^31); where the reference raises, the port raises the
same."""

import numpy as np
import pytest

from repro.core import competitors as ref

from repro_torch.core import competitors as port

MODELS = [
    "elias_fano_sequence_cost",
    "pef_uniform_cost",
    "pef_eps_optimal_cost",
    "bic_cost_bits",
    "optpfd_cost_bits",
    "ans_cost_bits",
]


def _clustered(rng):
    """Dense runs separated by wide gaps, the shape PEF and BIC exploit."""
    parts, base = [], 0
    for _ in range(12):
        run = int(rng.integers(20, 300))
        parts.append(base + np.arange(run))
        base += run + int(rng.integers(1, 50_000))
    return np.concatenate(parts)


SEQUENCES = {
    "empty": lambda rng: np.zeros(0, np.int64),
    "singleton-0": lambda rng: np.array([0]),
    "singleton-far": lambda rng: np.array([123_456_789]),
    "dense-from-0": lambda rng: np.arange(1_000),
    "dense-offset": lambda rng: np.arange(7, 519),
    "random-sparse": lambda rng: np.unique(rng.integers(0, 10**7, 2_000)),
    "random-dense": lambda rng: np.unique(rng.integers(0, 3_000, 2_500)),
    "clustered": _clustered,
    "u-past-2^31": lambda rng: np.unique(
        rng.integers(2**31 - 5_000, 2**33, 700)),
}


def _outcome(fn, seq):
    try:
        return fn(seq.copy())
    except Exception as e:  # the reference's own failure, held to the port
        return type(e)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_model_matches_reference(model, name):
    seq = np.asarray(SEQUENCES[name](np.random.default_rng(20)), np.int64)
    got = _outcome(getattr(port, model), seq)
    want = _outcome(getattr(ref, model), seq)
    assert got == want
    if not isinstance(want, type):
        assert type(got) is int and got >= 0


@pytest.mark.parametrize("n,u", [
    (0, 0), (0, 5), (1, 0), (5, -1), (3, 1), (128, 128), (128, 129),
    (1_000, 2**31), (7, 2**40),
])
def test_ef_cost_bits_matches_reference(n, u):
    assert port.ef_cost_bits(n, u) == ref.ef_cost_bits(n, u)


def test_pef_partition_cost_matches_reference():
    for n in range(1, 40):
        for u in range(n, 3 * n + 5):
            assert port._pef_partition_cost(n, u) == ref._pef_partition_cost(n, u)

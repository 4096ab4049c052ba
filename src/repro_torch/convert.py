"""Carry an index built by the JAX package over to the port.

For this system the index plays the role weights play for a model: it is
the state an engine serves.  ``index_arrays`` and ``index_from_arrays``
move it as a plain dict of numpy arrays (the ``PartitionedIndex`` fields
of ``repro.core.index``), so an index built once by either package is
served by the other without a rebuild.  The port's own build gives
byte-identical arrays for the same corpus, so both routes meet.
"""

from __future__ import annotations

import numpy as np

from .core.index import PartitionedIndex

ARRAY_FIELDS = (
    "list_part_offsets", "list_sizes", "endpoints", "sizes", "tags",
    "offsets", "payload", "freq_offsets", "freq_payload", "doc_lens",
)
SCALAR_FIELDS = ("n_lists", "F", "codecs")
DTYPES = {"tags": np.int8, "payload": np.uint8, "freq_payload": np.uint8}


def index_arrays(index) -> dict:
    """The serializable fields of a ``PartitionedIndex`` (either package)."""
    d = {k: np.asarray(getattr(index, k)) for k in ARRAY_FIELDS}
    d.update({k: getattr(index, k) for k in SCALAR_FIELDS})
    return d


def index_from_arrays(d: dict) -> PartitionedIndex:
    """A port ``PartitionedIndex`` from the reference's fields.

    ``d`` maps field names to numpy arrays (and ``n_lists`` / ``F`` /
    ``codecs`` to scalars); absent optional fields (the freq stream) take
    their defaults.  ``n_lists`` defaults to ``len(list_sizes)``.
    """
    kw = {}
    for k in ARRAY_FIELDS:
        if k in d:
            kw[k] = np.asarray(d[k], dtype=DTYPES.get(k, np.int64)).copy()
    missing = {"endpoints", "sizes", "tags", "offsets", "payload",
               "list_part_offsets", "list_sizes"} - set(kw)
    if missing:
        raise ValueError(f"index arrays missing: {sorted(missing)}")
    kw["n_lists"] = int(d.get("n_lists", len(kw["list_sizes"])))
    kw["F"] = int(d.get("F", 64))
    kw["codecs"] = str(d.get("codecs", "svb"))
    return PartitionedIndex(**kw)

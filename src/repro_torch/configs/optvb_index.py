"""The paper's own artifact: an optimally-partitioned VByte inverted index.

Counterpart of ``repro/configs/optvb_index.py``: the configuration of the
index-serving application (``launch/serve.py``), not one of the model
architectures of the registry.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    name: str = "optvb-index"
    F: int = 64                  # per-partition header bits (paper value)
    strategy: str = "optimal"    # optimal | eps | uniform | single
    uniform_block: int = 128
    # synthetic corpus calibration (Gov2-like; see data/postings.py)
    mean_dense_gap: float = 2.13
    mean_sparse_gap: float = 1850.0
    frac_dense: float = 0.80


FULL = IndexConfig()
SMOKE = IndexConfig(name="optvb-index-smoke")

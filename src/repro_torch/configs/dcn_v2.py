"""dcn-v2 [arXiv:2008.13535; paper].

n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3 mlp=1024-1024-512
interaction=cross.  Sparse tables: 26 fields x 2^20 rows (~1M, a
power-of-2 hash size), one flat table of 27,262,976 x 16.
Counterpart of ``repro/configs/dcn_v2.py``, field for field.
"""
from . import RECSYS_SHAPES, ArchBundle, register
from ..models.recsys import RecsysConfig

FULL = RecsysConfig(
    name="dcn-v2", kind="dcn", n_dense=13, n_sparse=26, embed_dim=16,
    rows_per_field=1_048_576, n_cross_layers=3, mlp=(1024, 1024, 512),
)
SMOKE = RecsysConfig(
    name="dcn-v2-smoke", kind="dcn", n_dense=13, n_sparse=6, embed_dim=8,
    rows_per_field=1_024, n_cross_layers=2, mlp=(32, 16),
)
BUNDLE = register(ArchBundle("dcn-v2", "recsys", FULL, SMOKE, RECSYS_SHAPES))

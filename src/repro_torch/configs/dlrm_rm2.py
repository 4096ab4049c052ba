"""dlrm-rm2 [arXiv:1906.00091; paper].

n_dense=13 n_sparse=26 embed_dim=64 bot_mlp=13-512-256-64
top_mlp=512-512-256-1 interaction=dot.  Table rows per field 2^20.
Counterpart of ``repro/configs/dlrm_rm2.py``, field for field.
"""
from . import RECSYS_SHAPES, ArchBundle, register
from ..models.recsys import RecsysConfig

FULL = RecsysConfig(
    name="dlrm-rm2", kind="dlrm", n_dense=13, n_sparse=26, embed_dim=64,
    rows_per_field=1_048_576, bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256),
)
SMOKE = RecsysConfig(
    name="dlrm-rm2-smoke", kind="dlrm", n_dense=13, n_sparse=6, embed_dim=8,
    rows_per_field=1_024, bot_mlp=(32, 16, 8), top_mlp=(32, 16),
)
BUNDLE = register(ArchBundle("dlrm-rm2", "recsys", FULL, SMOKE, RECSYS_SHAPES))

"""bst -- Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874; paper].

embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256
interaction=transformer-seq.
Counterpart of ``repro/configs/bst.py``, field for field.
"""
from . import RECSYS_SHAPES, ArchBundle, register
from ..models.recsys import RecsysConfig

FULL = RecsysConfig(
    name="bst", kind="bst", embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
    item_vocab=2_097_152,
)
SMOKE = RecsysConfig(
    name="bst-smoke", kind="bst", embed_dim=16, seq_len=6, n_blocks=1,
    n_heads=4, item_vocab=1_024,
)
BUNDLE = register(ArchBundle("bst", "recsys", FULL, SMOKE, RECSYS_SHAPES))

"""din [arXiv:1706.06978; paper].

embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80 interaction=target-attn.
Item vocab: 2^21 rows (2,097,152), one table.
Counterpart of ``repro/configs/din.py``, field for field.
"""
from . import RECSYS_SHAPES, ArchBundle, register
from ..models.recsys import RecsysConfig

FULL = RecsysConfig(
    name="din", kind="din", embed_dim=18, seq_len=100, attn_mlp=(80, 40),
    item_vocab=2_097_152,
)
SMOKE = RecsysConfig(
    name="din-smoke", kind="din", embed_dim=8, seq_len=10, attn_mlp=(16, 8),
    item_vocab=1_024,
)
BUNDLE = register(ArchBundle("din", "recsys", FULL, SMOKE, RECSYS_SHAPES))

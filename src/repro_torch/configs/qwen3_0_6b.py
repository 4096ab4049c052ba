"""qwen3-0.6b [hf:Qwen/Qwen3-8B; hf].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936 -- qk_norm, GQA.
Qwen3 uses d_head=128 decoupled from d_model/n_heads.
Counterpart of ``repro/configs/qwen3_0_6b.py``, field for field.
"""
from . import ArchBundle, lm_shapes, register
from ..models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_head=128, d_ff=3072, vocab=151936, qk_norm=True,
)
SMOKE = TransformerConfig(
    name="qwen3-0.6b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=192, vocab=512, qk_norm=True, attn_chunk=16, loss_chunk=16,
)
BUNDLE = register(ArchBundle("qwen3-0.6b", "lm", FULL, SMOKE, lm_shapes(True)))

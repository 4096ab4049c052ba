"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936 -- QKV bias.
Counterpart of ``repro/configs/qwen1_5_0_5b.py``, field for field.
"""
from . import ArchBundle, lm_shapes, register
from ..models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen1.5-0.5b", n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_head=64, d_ff=2816, vocab=151936, qkv_bias=True,
)
SMOKE = TransformerConfig(
    name="qwen1.5-0.5b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=176, vocab=512, qkv_bias=True, attn_chunk=16, loss_chunk=16,
)
BUNDLE = register(ArchBundle("qwen1.5-0.5b", "lm", FULL, SMOKE, lm_shapes(True)))

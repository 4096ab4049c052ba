"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
Counterpart of ``repro/configs/moonshot_v1_16b_a3b.py``, field for field.
"""
from . import ArchBundle, lm_shapes, register
from ..models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, d_head=128, d_ff=1408, vocab=163840,
    n_experts=64, top_k=6,
)
SMOKE = TransformerConfig(
    name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=88, vocab=512, n_experts=8, top_k=2, attn_chunk=16,
    loss_chunk=16,
)
BUNDLE = register(ArchBundle("moonshot-v1-16b-a3b", "lm", FULL, SMOKE, lm_shapes(True)))

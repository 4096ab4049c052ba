"""mixtral-8x22b [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA.
Sliding-window attention (window 4096) makes it sub-quadratic, so the
long_500k cell RUNS for this arch (window-bounded KV cache).
Counterpart of ``repro/configs/mixtral_8x22b.py``, field for field.
"""
from . import ArchBundle, lm_shapes, register
from ..models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_head=128, d_ff=16384, vocab=32768, n_experts=8, top_k=2,
    sliding_window=4096,
)
SMOKE = TransformerConfig(
    name="mixtral-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_head=8, d_ff=128, vocab=512, n_experts=4, top_k=2, sliding_window=16,
    attn_chunk=16, loss_chunk=16,
)
BUNDLE = register(ArchBundle("mixtral-8x22b", "lm", FULL, SMOKE, lm_shapes(False)))

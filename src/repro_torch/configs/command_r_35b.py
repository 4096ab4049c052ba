"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01; unverified].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 -- GQA, no-bias.
Counterpart of ``repro/configs/command_r_35b.py``, field for field.
"""
from . import ArchBundle, lm_shapes, register
from ..models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="command-r-35b", n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_head=128, d_ff=22528, vocab=256000, qkv_bias=False, qk_norm=False,
)
SMOKE = TransformerConfig(
    name="command-r-35b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=1,
    d_head=8, d_ff=176, vocab=512, qkv_bias=False, qk_norm=False, attn_chunk=16,
    loss_chunk=16,
)
BUNDLE = register(ArchBundle("command-r-35b", "lm", FULL, SMOKE, lm_shapes(True)))

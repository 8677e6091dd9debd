"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 384 experts top-8 + 1 shared.

[arXiv:2501.kimi2; unverified] 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840.  Adafactor for the dry-run memory budget (DESIGN.md §5).
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab=163840, n_experts=384,
    top_k=8, n_shared_experts=1, optimizer="adafactor",
    source="arXiv:2501.kimi2; unverified")

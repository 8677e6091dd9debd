"""zamba2-7b [hybrid]: 81L Mamba2 + shared attention/MLP blocks.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (GQA kv=32)
d_ff=14336 vocab=32000, ssm_state=64.  Sub-quadratic (Mamba2 state +
sliding-window shared attention) -> runs long_500k.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="mamba_hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000, ssm_state=64,
    ssm_headdim=64, attn_every=6, window=4096, subquadratic=True,
    source="arXiv:2411.15242; unverified")

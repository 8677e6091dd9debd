"""xlstm-125m [ssm]: alternating sLSTM + mLSTM blocks.

[arXiv:2405.04517; unverified] 12L d_model=768 4H d_ff=0 vocab=50304.
Recurrent state -> sub-quadratic -> runs long_500k.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="xlstm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, subquadratic=True,
    source="arXiv:2405.04517; unverified")

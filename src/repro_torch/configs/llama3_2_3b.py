"""llama3.2-3b [dense]. [hf:meta-llama/Llama-3.2-1B; unverified]
28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab=128256, tie_embeddings=True,
    rope_theta=500000.0, source="hf:meta-llama/Llama-3.2-1B; unverified")

"""internvl2-76b [vlm]: InternLM2-style backbone; the InternViT frontend
is a STUB -- input_specs provides precomputed patch embeddings prepended
to the text sequence. [arXiv:2404.16821; unverified]
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256, input_mode="mixed",
    n_patches=256, source="arXiv:2404.16821; unverified")

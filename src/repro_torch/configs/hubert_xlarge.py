"""hubert-xlarge [audio]: encoder-only backbone (w2v2 arch); the conv
feature frontend is a STUB -- input_specs provides precomputed frame
embeddings. [arXiv:2106.07447; unverified]
48L d_model=1280 16H d_ff=5120 vocab=504.  No decode step.
"""
from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504, causal=False,
    has_decode=False, input_mode="embeds",
    source="arXiv:2106.07447; unverified")

"""Architecture registry: --arch <id> resolves here.

The JAX package's ten configurations, as data (``ArchConfig.dtype`` is a
torch dtype), and the dry-run's input shapes (``SHAPES``, from
:mod:`repro_torch.configs.shapes`).
"""
from repro_torch.configs import shapes
from repro_torch.configs.zamba2_7b import CONFIG as zamba2_7b
from repro_torch.configs.llama4_scout_17b_a16e import \
    CONFIG as llama4_scout_17b_a16e
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as kimi_k2_1t_a32b
from repro_torch.configs.llama3_2_3b import CONFIG as llama3_2_3b
from repro_torch.configs.deepseek_67b import CONFIG as deepseek_67b
from repro_torch.configs.qwen1_5_0_5b import CONFIG as qwen1_5_0_5b
from repro_torch.configs.qwen2_5_32b import CONFIG as qwen2_5_32b
from repro_torch.configs.xlstm_125m import CONFIG as xlstm_125m
from repro_torch.configs.hubert_xlarge import CONFIG as hubert_xlarge
from repro_torch.configs.internvl2_76b import CONFIG as internvl2_76b

ARCHS = {c.name: c for c in [
    zamba2_7b, llama4_scout_17b_a16e, kimi_k2_1t_a32b, llama3_2_3b,
    deepseek_67b, qwen1_5_0_5b, qwen2_5_32b, xlstm_125m, hubert_xlarge,
    internvl2_76b,
]}

SHAPES = shapes.SHAPES


def get(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]

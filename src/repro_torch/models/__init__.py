"""Model zoo: the paper's HFL CNNs (:mod:`repro_torch.models.cnn`),
transformer layers (:mod:`repro_torch.models.layers`), the MoE FFN
(:mod:`repro_torch.models.moe`), the Mamba2 and xLSTM blocks
(:mod:`repro_torch.models.ssm`) and the dense, moe, hybrid and xlstm
families with their decode caches (:mod:`repro_torch.models.transformer`)."""
from repro_torch.models import layers, moe, ssm, transformer
from repro_torch.models.transformer import (ArchConfig, cache_defs,
                                            decode_step, forward, init_cache,
                                            init_params, make_prefill_step,
                                            make_serve_step, param_defs,
                                            params_from_numpy,
                                            prefill_cache_to_decode)

__all__ = ["layers", "moe", "ssm", "transformer", "ArchConfig", "cache_defs",
           "decode_step", "forward", "init_cache", "init_params",
           "make_prefill_step", "make_serve_step", "param_defs",
           "params_from_numpy", "prefill_cache_to_decode"]

"""Model zoo: transformer layers (:mod:`repro_torch.models.layers`) and the
dense transformer family with KV-cache decode
(:mod:`repro_torch.models.transformer`)."""

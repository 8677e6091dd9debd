"""Model zoo: the paper's HFL CNNs (:mod:`repro_torch.models.cnn`),
transformer layers (:mod:`repro_torch.models.layers`), the MoE FFN
(:mod:`repro_torch.models.moe`) and the dense and moe transformer
families with KV-cache decode (:mod:`repro_torch.models.transformer`)."""

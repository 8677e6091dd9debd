"""Model zoo: the paper's HFL CNNs (:mod:`repro_torch.models.cnn`),
transformer layers (:mod:`repro_torch.models.layers`) and the dense
transformer family with KV-cache decode
(:mod:`repro_torch.models.transformer`)."""

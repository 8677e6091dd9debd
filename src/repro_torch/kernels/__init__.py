"""Hand-written Hopper kernels (``csrc/*.cu``), their launchers, their
plain PyTorch versions (:mod:`repro_torch.kernels.ref`) and the public
wrappers (:mod:`repro_torch.kernels.ops`)."""

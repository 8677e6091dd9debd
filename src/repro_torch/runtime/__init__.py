"""Fault tolerance for the HFL runtime (:mod:`repro_torch.runtime.fault`)."""
from repro_torch.runtime import fault

__all__ = ["fault"]

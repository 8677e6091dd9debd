"""Fault tolerance for the HFL runtime (:mod:`repro_torch.runtime.fault`)
and the logical-axis sharding rules (:mod:`repro_torch.runtime.sharding`,
imported on demand)."""
from repro_torch.runtime import fault

__all__ = ["fault"]

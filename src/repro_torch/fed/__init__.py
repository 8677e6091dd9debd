"""Federated learning: the upload compression ladder and uplink transforms
(:mod:`repro_torch.fed.compression`), Algorithm 1 batched over users
(:mod:`repro_torch.fed.hfl`) and deadline-based straggler dropping
(:mod:`repro_torch.fed.straggler`)."""
from repro_torch.fed import compression, hfl, straggler
from repro_torch.fed.compression import (CompressionLadder, CompressionLevel,
                                         compressed_bytes, default_ladder)
from repro_torch.fed.hfl import HflConfig, run_fl, run_hfl

__all__ = ["compression", "hfl", "straggler", "CompressionLadder",
           "CompressionLevel", "compressed_bytes", "default_ladder",
           "HflConfig", "run_fl", "run_hfl"]

"""Federated-learning pieces the planner needs: the upload compression
ladder (:mod:`repro_torch.fed.compression`)."""
from repro_torch.fed.compression import (CompressionLadder, CompressionLevel,
                                         compressed_bytes, default_ladder)

__all__ = ["CompressionLadder", "CompressionLevel", "compressed_bytes",
           "default_ladder"]

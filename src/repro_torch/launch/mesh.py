"""Production mesh definitions (single-pod 16x16, multi-pod 2x16x16) on
``torch.distributed`` (the JAX package's ``launch/mesh.py``), and the
H100's constants for the dry-run's roofline.

``make_production_mesh`` is a *function*: importing this module touches no
process group.  It builds the mesh over the current default process group,
which must span exactly ``mesh_device_count`` ranks (the dry-run opens a
fake one; see :mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations


def mesh_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = mesh_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_device_count(multi_pod: bool = False) -> int:
    return 512 if multi_pod else 256


# NVIDIA H100 SXM constants used by the roofline analysis (per card).
# Dense bf16 tensor-core peak, without sparsity (H100 SXM data sheet).
PEAK_FLOPS_BF16 = 989e12        # FLOP/s
# HBM3 bandwidth (H100 SXM data sheet).
HBM_BW = 3.35e12                # bytes/s
# The collective term's rate: one NDR InfiniBand link of 400 Gb/s a card
# (ConnectX-7, the DGX H100's scale-out network).  Every axis of a 16-wide
# mesh crosses the 8-card NVLink nodes, so its collectives run at this rate.
NET_BW = 50e9                   # bytes/s per card
# NVLink 4 within a node: 900 GB/s a card both ways, 450 GB/s a direction
# (H100 SXM data sheet), for axes that stay inside one node.
NVLINK_BW = 450e9               # bytes/s per card and direction

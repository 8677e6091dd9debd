"""Synthetic datasets and federated partitions (numpy, bitwise the JAX
package's draws)."""
from repro_torch.data.partitioner import (dirichlet_partition, iid_partition,
                                          partition_to_users)
from repro_torch.data.synthetic import (DATASET_SHAPES, SyntheticImageDataset,
                                        make_dataset, token_stream)

__all__ = ["DATASET_SHAPES", "SyntheticImageDataset", "dirichlet_partition",
           "iid_partition", "make_dataset", "partition_to_users",
           "token_stream"]

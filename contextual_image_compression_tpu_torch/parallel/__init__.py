"""Distributed execution over a (data, model) mesh of torch.distributed ranks.

Counterpart of `contextual_image_compression_tpu/parallel`: one process per
device, data-parallel batches, the largest parameters split over the model
axis, and the collectives that JAX's SPMD partitioner inserts written out
(parallel/collectives.py), so the mesh computes the global-batch step.
"""

from contextual_image_compression_tpu_torch.parallel.mesh import Mesh as Mesh
from contextual_image_compression_tpu_torch.parallel.mesh import create_mesh as create_mesh
from contextual_image_compression_tpu_torch.parallel.mesh import (
    initialize_multihost as initialize_multihost,
)
from contextual_image_compression_tpu_torch.parallel import sharding as sharding

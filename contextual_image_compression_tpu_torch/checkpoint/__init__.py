"""Checkpoints in the JAX package's files: flax's msgpack format read and
written without flax or msgpack (flax_msgpack.py), and the component store
with its load ladder (store.py)."""

from contextual_image_compression_tpu_torch.checkpoint.store import CheckpointStore

__all__ = ["CheckpointStore"]

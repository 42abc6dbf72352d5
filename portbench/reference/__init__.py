"""Plain PyTorch reference of the codec, its mask engine and its training
step. It imports nothing of the port and nothing of JAX: it works every
derived quantity (w8 rows, bf16 parameters, the folded int8 tail, the masks,
the batch order) out again from the weights and inputs the benchmark made.
"""

"""Synthetic corpora, the mask precompute and the epoch batcher."""

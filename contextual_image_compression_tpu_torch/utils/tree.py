"""Sizes and non-finite leaves of parameter trees.

Counterpart of `param_count`, `param_bytes` and `find_nonfinite` in
`contextual_image_compression_tpu/utils/tree.py`. A tree here is an
`nn.Module` (its state dict: parameters and buffers), a state dict, or a
nested dict of numpy arrays or tensors, as the checkpoint store holds them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) of every array leaf, in the tree's order."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (np.ndarray, np.generic, torch.Tensor)):
        yield prefix, tree


def param_count(tree: Any) -> int:
    return sum(int(np.prod(x.shape)) for _, x in leaves(tree))


def param_bytes(tree: Any) -> int:
    def nbytes(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        return int(np.prod(x.shape)) * x.dtype.itemsize

    return sum(nbytes(x) for _, x in leaves(tree))


def find_nonfinite(tree: Any) -> Dict[str, int]:
    """{path: number of non-finite elements} of the floating leaves that
    hold any (a debugging aid: one host read per leaf)."""
    bad = {}
    for path, x in leaves(tree):
        if isinstance(x, torch.Tensor):
            n = int((~torch.isfinite(x)).sum()) if x.is_floating_point() else 0
        else:
            n = int(np.sum(~np.isfinite(x))) if np.issubdtype(x.dtype, np.floating) else 0
        if n:
            bad[path] = n
    return bad

"""Sizes, finiteness and dtype casts of parameter trees.

Counterpart of `contextual_image_compression_tpu/utils/tree.py`
(`param_count`, `param_bytes`, `tree_finite`, `find_nonfinite`,
`cast_floats`). A tree here is an `nn.Module` (its state dict: parameters
and buffers), a state dict, or a nested dict of numpy arrays or tensors, as
the checkpoint store holds them.
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


def tree_finite(tree: Any) -> torch.Tensor:
    """0-dim bool tensor: every leaf finite everywhere (integer leaves are).
    Tensor leaves are reduced where they lie, so a caller pays one host read
    for the whole tree."""
    flags = []
    for _, x in leaves(tree):
        if isinstance(x, torch.Tensor):
            flags.append(torch.isfinite(x).all().cpu() if x.is_floating_point()
                         else torch.tensor(True))
        elif np.issubdtype(x.dtype, np.floating):
            flags.append(torch.tensor(bool(np.isfinite(x).all())))
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


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


def cast_floats(tree: Any, dtype: torch.dtype, skip_keys: tuple = ("w8_scale",),
                buffers: bool = True) -> Any:
    """Cast the floating leaves to `dtype`, leaving those named in
    `skip_keys` (the float32 w8 scale rows that serving keeps) as they are.
    An `nn.Module` is cast in place and returned: its parameters, and its
    buffers unless `buffers=False` (a flax module's param_dtype, which keeps
    the BatchNorm statistics float32); a nested dict comes back as a new
    tree of tensors, numpy leaves converted."""
    if isinstance(tree, torch.nn.Module):
        for mod in tree.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                if p.is_floating_point() and name not in skip_keys:
                    p.data = p.data.to(dtype)
            for name, b in list(mod.named_buffers(recurse=False)) if buffers else ():
                if b is not None and b.is_floating_point() and name not in skip_keys:
                    setattr(mod, name, b.to(dtype))
        return tree

    def one(key, x):
        if isinstance(x, dict):
            return {k: one(k, v) for k, v in x.items()}
        if isinstance(x, (np.ndarray, np.generic)):
            x = torch.from_numpy(np.array(x))
        if isinstance(x, torch.Tensor) and x.is_floating_point() and key not in skip_keys:
            return x.to(dtype)
        return x

    return one(None, tree)

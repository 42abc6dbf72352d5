"""Image ops, saliency and the wrappers of the port's CUDA kernels.

Each kernel wrapper counts its launches in a plain integer attribute,
`<wrapper>.launches`; `launch_counts()` reads them and `reset_launch_counts()`
sets them to 0. The mask kernels K1 and K4 also count them per route
(`.route_launches`, read by `route_counts()`).
"""

from contextual_image_compression_tpu_torch.ops.attention import (
    attention_block,
    attention_core,
    sagan_block,
    sagan_block_spatial,
)
from contextual_image_compression_tpu_torch.ops.dct import dct_strips
from contextual_image_compression_tpu_torch.ops.fused_mask import contextual_mask, smooth_mask
from contextual_image_compression_tpu_torch.ops.generator_tail import fused_tail
from contextual_image_compression_tpu_torch.ops.quantize import (
    adaptive_quantize,
    adaptive_quantize_bwd,
)

KERNEL_WRAPPERS = {
    "K1": contextual_mask,
    "K2": attention_block,
    "K3": adaptive_quantize,
    "K3b": adaptive_quantize_bwd,
    "K4": smooth_mask,
    "K5": dct_strips,
    "K6": attention_core,
    "K7a": sagan_block,
    "K7b": sagan_block_spatial,
    "K8": fused_tail,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def route_counts() -> dict:
    """Launches per route of the kernels that have two: {'K1': {'cluster': n,
    'tiled': m}, 'K4': {...}}."""
    return {name: dict(fn.route_launches) for name, fn in KERNEL_WRAPPERS.items()
            if hasattr(fn, "route_launches")}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = {route: 0 for route in fn.route_launches}

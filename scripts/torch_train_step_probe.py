"""The tiny GAN train step that chip_smoke.py holds against the CPU, under
variants that show where the card's gradients leave the CPU's.

    python3 scripts/torch_train_step_probe.py CHECKOUT [twin] [noperc] [unpinned]

Imports chip_smoke.py and the port from the checkout at CHECKOUT and runs
its `_small_train_step_agreement` with convolutions outside cuDNN (the run
chip_smoke.py holds to its bars), printing the per-component gradient
agreement of both steps. Options:

  twin      K2's float32 launches run K2's twin on the card instead;
  noperc    the perceptual (VGG19) loss is 0 on both sides;
  unpinned  VGG19's ReLU and max-pool decisions on the card are its own
            (a checkout whose chip_smoke.py does not pin them always is).

Run it on a parent and a change in one call to compare them. It needs a
CUDA device.
"""

import contextlib
import os
import sys

import torch


def main():
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    root = os.path.realpath(sys.argv[1])
    opts = set(sys.argv[2:])
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke
    from contextual_image_compression_tpu_torch.ops import attention
    from contextual_image_compression_tpu_torch.train import gan_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "twin" in opts:
        kernel = attention._attention_block_kernel

        def twin_for_float32(q, k, v, residual, gamma):
            if q.dtype != torch.float32:
                return kernel(q, k, v, residual, gamma)
            attention.attention_block.launches += 1
            return attention.attention_block_plain(q, k, v, residual, gamma)

        attention._attention_block_kernel = twin_for_float32
    if "noperc" in opts:
        gan_trainer.GANStepBuilder.perceptual = (
            lambda self, images, compressed: torch.zeros((), device=images.device))
    if "unpinned" in opts and hasattr(chip_smoke, "_PinnedVggDecisions"):
        class Unpinned(contextlib.AbstractContextManager):
            def drained(self):
                pass

            def __exit__(self, *exc):
                return None

        chip_smoke._PinnedVggDecisions = Unpinned
    pinned = hasattr(chip_smoke, "_PinnedVggDecisions") and "unpinned" not in opts
    print(f"checkout {root}; options {sorted(opts)}; VGG19 decisions "
          f"{'pinned to the CPU' if pinned else 'the card'}'s", flush=True)
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        chip_smoke._small_train_step_agreement(torch.device("cuda"), "convolutions without cuDNN")
    return 0


if __name__ == "__main__":
    sys.exit(main())

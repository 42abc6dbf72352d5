"""Work of the float32 training configuration, from its shapes.

`step_flops`: one step's model FLOPs (harness/flops.py `train_ops`): the
codec's forward and backward, D's phase when it runs, the pass through D
for the adversarial loss, and VGG19 on both images with the input gradient
of the generated one when the perceptual loss is on.
`attention`: FLOPs and bytes of the HQ attention block's forward at batch
b in float32 (4-byte elements).
"""

from portbench.harness import flops

ELEM_BYTES = 4


def step_flops(m: dict, b: int, do_d: bool, use_perceptual: bool) -> float:
    return flops.total(flops.train_ops(m, b, do_d, use_perceptual), backward=True)


def attention(m: dict, b: int):
    return flops.attention_cost(m, b, ELEM_BYTES)

"""Work of the bf16 / w8 serving configuration, from its shapes.

`flops_per_image`: the served forward's model FLOPs (harness/flops.py:
both encoders with the HQ attention, the saliency nets, the RD net, both
generators with the folded tail); 23.7 GFLOP at the published widths.
`attention`: FLOPs and bytes of the HQ attention block at batch b in
bf16 (2-byte elements).
"""

from portbench.harness import flops

ELEM_BYTES = 2


def flops_per_image(m: dict) -> float:
    return flops.total(flops.serve_ops(m, 1), backward=False)


def attention(m: dict, b: int):
    return flops.attention_cost(m, b, ELEM_BYTES)

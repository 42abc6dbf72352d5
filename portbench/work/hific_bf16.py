"""Work of HiFiC's bf16 serving configuration, from its shapes, per image of
h x w pixels (multiples of 64), counted as harness/flops.py counts: 2 FLOPs
a multiply-add of every convolution over its output (a transposed one over
its input) and of the factorized prior's products (each value of z_hat
taken at +-0.5); ChannelNorm, the roundings and the Gaussian likelihood
do not count.

At 2048 x 1536 (published widths): 4.79 TFLOP an image, of which the 9
residual blocks 3.67, E 0.51, the hyperprior 0.11.

`resblocks`: FLOPs and bytes of the 18 convolutions of the residual blocks,
each reading its input and weights and writing its output once in bf16
(2-byte elements).
"""

ELEM_BYTES = 2


def _conv(hw_out: float, cin: int, cout: int, k: int) -> float:
    return 2.0 * hw_out * cin * cout * k * k


def parts(m: dict, h: int, w: int) -> dict:
    """FLOPs of E, the hyperprior (h_a and both syntheses), the residual
    blocks and the rest of G, per image."""
    f = list(m["encoder_filters"])
    cy, n, c = m["latent_channels"], m["hyper_channels"], m["channels"]
    px = float(h * w)
    enc = _conv(px, c, f[0], 7)
    for i, (a, b) in enumerate(zip(f, f[1:]), start=1):
        enc += _conv(px / 4 ** i, a, b, 3)
    lat = px / 4 ** (len(f) - 1)
    enc += _conv(lat, f[-1], cy, 3)
    hyper = _conv(lat, cy, n, 3) + _conv(lat / 4, n, n, 5) + _conv(lat / 16, n, n, 5)
    hyper += 2 * (_conv(lat / 16, n, n, 5) + _conv(lat / 4, n, n, 5) + _conv(lat, n, cy, 3))
    dims = [1] + list(m["factorized_filters"]) + [1]
    hyper += 2 * 2.0 * n * lat / 16 * sum(a * b for a, b in zip(dims, dims[1:]))
    g = f[::-1]
    blocks = 2 * m["residual_blocks"] * _conv(lat, g[0], g[0], 3)
    rest = _conv(lat, cy, g[0], 3)
    for i, (a, b) in enumerate(zip(g, g[1:])):
        rest += _conv(lat * 4 ** i, a, b, 3)  # over the transposed conv's input
    rest += _conv(px, g[-1], c, 7)
    return {"encoder": enc, "hyperprior": hyper, "resblocks": blocks, "generator_rest": rest}


def flops_per_image(m: dict, h: int, w: int) -> float:
    return sum(parts(m, h, w).values())


def resblocks(m: dict, h: int, w: int):
    """(FLOPs, bytes) of the residual blocks' convolutions, per image."""
    c = m["encoder_filters"][-1]
    lat = float(h * w) / 4 ** (len(m["encoder_filters"]) - 1)
    convs = 2 * m["residual_blocks"]
    nbytes = convs * ELEM_BYTES * (2 * c * lat + 9 * c * c + c)
    return parts(m, h, w)["resblocks"], nbytes

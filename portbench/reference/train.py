"""The GAN training step in plain PyTorch, float32 (the reference recipe).

One step (D trained when `do_d`):

  1. the codec's training forward (codec.train_forward);
  2. D phase: d_loss = 0.5 (BCE(0.9, D(real)) + BCE(0.1, D(fake))), the
     fake detached, D's BatchNorm on its running statistics; one Adam step
     of D;
  3. G phase with the updated D (its parameters cut from the graph):
       g = 0.35 MSE + 0.15 L1 + 0.15 perceptual + 0.15 BCE(1, D(fake))
           + 0.20 |bpp_actual - bpp_target|,   g += 0.5 max(0, 0.5 - g)
       perceptual = 0.5 sum_i w_i MSE(z(VGG_i(real)), z(VGG_i(fake))),
           z the whole tensor's z-score (biased std), taps of VGG19 on
           caffe-style inputs, w = (0.1, 0.1, 0.2, 0.3, 0.3)
       ls = 0.1 [(s_hq - mean mask)^2 + (s_lq - (1 - mean mask))^2]
       rd = 0.3 MSE(rd[:, 0], clip(1 - bpp / 4, 0.1, 0.9))
            + 0.7 |bpp_actual - bpp_target|
            + mean(relu(target - actual) relu(target - 1) 2)
     one backward of g + ls + rd; keras Adam on the generator group
     (encoders and generators), the latent-saliency nets (lr / 2) and the
     RD net (lr / 2): each gradient clipped to norm 1 on its own, then
     m / (sqrt(v) + 1e-7) with bias corrections; then the codec's running
     statistics take the forward's batch statistics.

bpp_actual = (hq * 2D * 32 + (1 - hq) * D * 32) / (H W), hq the mean blend
map of the image.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import codec as C
from portbench.reference.precision import FLOAT32

VGG19_LAYOUT = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
VGG19_TAPS = ((1, 2), (2, 2), (3, 4), (4, 4), (5, 4))
BGR_MEAN = (103.939, 116.779, 123.68)
KERAS_EPS = 1e-7
GENERATOR_PREFIXES = ("hq_encoder.", "hq_generator.", "lq_encoder.", "lq_generator.")


def disc_shapes(m: dict) -> Dict[str, Tuple[int, ...]]:
    h = m["img_size"][0]
    stages = min(max(1, int(math.log2(h / 4))), m["disc_max_stages"])
    shapes, f, cin = {}, m["disc_base_filters"], m["channels"]
    for i in range(stages):
        shapes[f"conv{i}.weight"] = (f, cin, 4, 4)
        shapes[f"conv{i}.bias"] = (f,)
        if i > 0:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"bn{i}.{leaf}"] = (f,)
        cin, f = f, min(f * 2, m["disc_max_filters"])
    hw = h >> stages
    shapes["dense.weight"] = (m["disc_dense_units"], cin * hw * hw)
    shapes["dense.bias"] = (m["disc_dense_units"],)
    shapes["out.weight"] = (1, m["disc_dense_units"])
    shapes["out.bias"] = (1,)
    return shapes


def vgg_shapes() -> Dict[str, Tuple[int, ...]]:
    shapes, cin = {}, 3
    for bi, (width, n) in enumerate(VGG19_LAYOUT, start=1):
        for ci in range(1, n + 1):
            shapes[f"block{bi}_conv{ci}.weight"] = (width, cin, 3, 3)
            shapes[f"block{bi}_conv{ci}.bias"] = (width,)
            cin = width
    return shapes


def discriminator(p, x, m, rnd=FLOAT32):
    s = m["leaky_slope"]
    i = 0
    while f"conv{i}.weight" in p:
        x = C.leaky(C.conv(x, p[f"conv{i}.weight"], p[f"conv{i}.bias"], 2, rnd), s)
        if i > 0:
            x = C.batch_norm(p, f"bn{i}", x, rnd=rnd)
        i += 1
    x = C.leaky(C.dense(x.reshape(x.shape[0], -1), p["dense.weight"], p["dense.bias"], rnd), s)
    return torch.sigmoid(C.dense(x, p["out.weight"], p["out.bias"], rnd))


def vgg19(p, x, rnd=FLOAT32) -> List[torch.Tensor]:
    taps = []
    for bi, (_, n) in enumerate(VGG19_LAYOUT, start=1):
        for ci in range(1, n + 1):
            x = F.relu(rnd.results(F.conv2d(rnd.operands(x),
                                            rnd.operands(p[f"block{bi}_conv{ci}.weight"]),
                                            p[f"block{bi}_conv{ci}.bias"], padding=1)))
            if (bi, ci) in VGG19_TAPS:
                taps.append(x)
        if bi < len(VGG19_LAYOUT):
            x = F.max_pool2d(x, 2, 2)
    return taps


def caffe(img):
    x = ((img + 1.0) * 127.5).flip(1)
    return x - torch.tensor(BGR_MEAN, device=img.device)[:, None, None]


def bce(label: float, probs):
    pr = torch.clamp(probs, KERAS_EPS, 1.0 - KERAS_EPS)
    return -torch.mean(label * torch.log(pr) + (1.0 - label) * torch.log(1.0 - pr))


def zscore(f):
    return (f - f.mean()) / (f.std(correction=0) + 1e-8)


def actual_bpp(t, m):
    d = m["base_latent_dim"]
    h, w = m["img_size"]
    hq = t.mean(dim=(1, 2, 3))
    return (hq * (2 * d) * 32.0 + (1.0 - hq) * d * 32.0) / float(h * w)


class KerasAdam:
    """Per-tensor clip to `clipnorm`, then Adam (eps outside the root)."""

    def __init__(self, names, lr, clipnorm=1.0, b1=0.9, b2=0.999, eps=1e-7):
        self.names, self.lr, self.clip = list(names), lr, clipnorm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n in self.names:
            g = grads.get(n)
            g = torch.zeros_like(params[n]) if g is None else g
            g = g * torch.clamp(self.clip / torch.clamp(torch.linalg.vector_norm(g), min=1e-12),
                                max=1.0)
            m = self.m.get(n, torch.zeros_like(g)) * self.b1 + (1.0 - self.b1) * g
            v = self.v.get(n, torch.zeros_like(g)) * self.b2 + (1.0 - self.b2) * g * g
            self.m[n], self.v[n] = m, v
            params[n] -= self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps)


class Trainer:
    """The reference's state (codec, D, the VGG tower, four optimizers) and
    its step. `tcfg`: the configuration's training block."""

    def __init__(self, codec_sd, disc_sd, vgg_sd: Optional[dict], m: dict, tcfg: dict,
                 rnd=FLOAT32):
        self.m, self.t, self.rnd = m, tcfg, rnd
        self.p = {k: v.detach().float().clone() for k, v in codec_sd.items()}
        self.d = {k: v.detach().float().clone() for k, v in disc_sd.items()}
        self.vgg = vgg_sd
        lr = tcfg["learning_rate"]
        trainable = [k for k in self.p if "running_" not in k]
        adam = dict(clipnorm=tcfg["clipnorm"], b1=tcfg["adam_b1"], b2=tcfg["adam_b2"],
                    eps=tcfg["adam_eps"])
        self.g_opt = KerasAdam([k for k in trainable if k.startswith(GENERATOR_PREFIXES)],
                               lr, **adam)
        self.ls_opt = KerasAdam([k for k in trainable if k.startswith("latent_saliency_")],
                                lr * tcfg["ls_lr_scale"], **adam)
        self.rd_opt = KerasAdam([k for k in trainable if k.startswith("rd_optimizer.")],
                                lr * tcfg["rd_lr_scale"], **adam)
        self.d_opt = KerasAdam([k for k in self.d if "running_" not in k], lr, **adam)

    def _grads(self, loss, params: Dict[str, torch.Tensor], names):
        leaves = [params[n] for n in names]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, retain_graph=True)
        return {n: g for n, g in zip(names, grads) if g is not None}

    def step(self, image, mask, bpp, do_d: bool, use_perceptual: bool):
        """One step on a batch (NCHW, [-1, 1]); returns (losses as floats,
        the raw gradients of every trainable leaf, by name)."""
        m, t, rnd = self.m, self.t, self.rnd
        lw = t["loss"]
        coeff = m["quantizer"]["scale_coeff"]
        trainable = self.g_opt.names + self.ls_opt.names + self.rd_opt.names
        for n in trainable:
            self.p[n].requires_grad_(True)
        stats: dict = {}
        out = C.train_forward(self.p, m, image, mask, bpp, coeff, stats, rnd)
        blended = out["blended"]
        losses: Dict[str, float] = {}
        grads: Dict[str, torch.Tensor] = {}
        if do_d:
            dn = self.d_opt.names
            for n in dn:
                self.d[n].requires_grad_(True)
            d_loss = 0.5 * (bce(lw["d_real_label"], discriminator(self.d, image, m, rnd))
                            + bce(lw["d_fake_label"], discriminator(self.d, blended.detach(), m,
                                                                    rnd)))
            dg = self._grads(d_loss, self.d, dn)
            for n in dn:
                self.d[n].requires_grad_(False)
            self.d_opt.step(self.d, dg)
            grads.update({f"disc.{n}": g for n, g in dg.items()})
            losses["d_loss"] = float(d_loss.detach())
        frozen_d = {k: v.detach() for k, v in self.d.items()}
        adv = bce(1.0, discriminator(frozen_d, blended, m, rnd))
        recon = torch.mean((image - blended) ** 2)
        l1 = torch.mean(torch.abs(image - blended))
        if use_perceptual and self.vgg is not None:
            with torch.no_grad():
                orig = vgg19(self.vgg, caffe(image), rnd)
            gen = vgg19(self.vgg, caffe(blended), rnd)
            perc = sum(w * torch.mean((zscore(o) - zscore(g)) ** 2)
                       for w, o, g in zip(lw["perceptual_layer_weights"], orig, gen))
            perc = perc * lw["perceptual_scale"]
        else:
            perc = torch.zeros((), device=image.device)
        flat = mask.mean(dim=(1, 2, 3))[:, None]
        ls_raw = torch.mean((out["s_hq"] - flat) ** 2) + torch.mean((out["s_lq"] - (1 - flat)) ** 2)
        lo, hi = lw["rd_target_clip"]
        rd_raw = torch.mean((out["rd"][:, 0:1]
                             - torch.clamp(1.0 - bpp / lw["rd_target_bpp_divisor"], lo, hi)) ** 2)
        actual = actual_bpp(out["t"], m)[:, None]
        control = torch.mean(torch.abs(actual - bpp))
        under = torch.mean(torch.relu(bpp - actual) * torch.relu(bpp - 1.0) * 2.0)
        g = (lw["recon_weight"] * recon + lw["l1_weight"] * l1 + lw["perceptual_weight"] * perc
             + lw["adv_weight"] * adv + lw["bitrate_weight"] * control)
        g = g + torch.clamp(lw["g_loss_floor"] - g, min=0.0) * lw["g_loss_floor_coeff"]
        total = (g + lw["ls_loss_weight"] * ls_raw
                 + lw["rd_loss_weight"] * rd_raw + lw["rd_bitrate_weight"] * control + under)
        cg = self._grads(total, self.p, trainable)
        for n in trainable:
            self.p[n].requires_grad_(False)
        for opt in (self.g_opt, self.ls_opt, self.rd_opt):
            opt.step(self.p, cg)
        with torch.no_grad():
            for name, (mean, var) in stats.items():
                rm, rv = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
                rm.copy_(C.BN_MOMENTUM * rm + (1 - C.BN_MOMENTUM) * mean)
                rv.copy_(C.BN_MOMENTUM * rv + (1 - C.BN_MOMENTUM) * var)
        grads.update(cg)
        losses.update({k: float(v.detach()) for k, v in (
            ("g_loss", g), ("reconstruction_loss", recon), ("gan_loss", adv), ("l1_loss", l1),
            ("perceptual_loss", perc), ("latent_saliency_loss", ls_raw), ("rd_loss", rd_raw),
            ("bitrate_control_loss", control))})
        return losses, grads

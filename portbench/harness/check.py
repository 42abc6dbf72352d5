"""The numbers that decide `correct`, each the gap between what the timed
path produced and the plain reference (portbench/reference/).

Serving, over the images of the kept calls:
  * mask_gap: the largest |mask - reference mask|;
  * decoded_far: the worst image's share of uint8 values more than 3
    levels from the reference's;
  * symbol_mismatch: the share of latent symbols (both branches) that
    differ from the reference's, over all the images;
and, read but not held to a limit: decoded_rmse, the worst image's root
mean square of (decoded - reference) in uint8 levels, which the float8
control moves only about 3 times as far as bfloat16 rounding does;
symbol_mismatch_worst, the worst image's share; symbol_gap, ||symbols -
reference|| / ||reference||, which the many zero symbols make a ratio of a
few unit flips to a small norm.

Training, over the first three steps, which the reference follows from
the same weights and batches:
  * first_loss_gap: the largest |loss - reference| / |reference| of the
    first step's losses that precede every update (D's loss, the
    reconstruction, L1, perceptual, latent-saliency, RD and bitrate
    terms; the adversarial term and the generator's total follow D's
    first update);
  * loss_gap (read, not held to a limit): the same over all three steps'
    losses, which Adam's first updates make chaotic (see PERF.md);
  * grad_gap: the worst leaf's | ||g|| - ||g_ref|| | / max(||g_ref||,
    the median leaf's ||g_ref||), g the raw gradient of the first step as
    its optimizer receives it (D's and the codec's);
  * update_gap: the same of each leaf's change after three steps, the
    BatchNorm statistics included, leaving out the parameters whose
    first reference gradient is under a thousandth of the median leaf's
    (they move by round-off alone).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import codec as ref_codec
from portbench.reference import masks as ref_masks
from portbench.reference.precision import FLOAT32

LOSS_KEYS = ("d_loss", "g_loss", "reconstruction_loss", "gan_loss", "l1_loss",
             "perceptual_loss", "latent_saliency_loss", "rd_loss", "bitrate_control_loss")
AFTER_D_UPDATE = ("gan_loss", "g_loss")  # computed with the step's updated D
GRAD_FLOOR = 1e-3


def serving_reference(params, tails, spec: dict, images_u8: torch.Tensor, bpp: float,
                      rnd=FLOAT32, mask_rnd=FLOAT32) -> Dict[str, torch.Tensor]:
    """The reference's answer to one call, on the host: decoded, mask,
    symbols."""
    m = spec["model"]
    mask = ref_masks.contextual_mask(images_u8, spec["saliency"], mask_rnd)
    decoded, hq, lq = ref_codec.serve(params, tails, m, images_u8, mask, bpp,
                                      m["quantizer"]["scale_coeff"], rnd)
    return {"decoded": decoded.cpu(), "mask": mask.cpu(), "hq_symbols": hq.cpu(),
            "lq_symbols": lq.cpu()}


def serving_gaps(got: List[dict], want: List[dict]) -> Dict[str, float]:
    mask_gap = rmse = sym = worst_mismatch = far = 0.0
    differ = total = 0
    for g, w in zip(got, want):
        mask_gap = max(mask_gap, float((g["mask"].float() - w["mask"]).abs().max()))
        d = (g["decoded"].float() - w["decoded"].float()).flatten(1)
        rmse = max(rmse, float(torch.sqrt((d * d).mean(dim=1)).max()))
        far = max(far, float((d.abs() > 3).float().mean(dim=1).max()))
        gs = torch.cat([g["hq_symbols"].float(), g["lq_symbols"].float()], dim=1)
        ws = torch.cat([w["hq_symbols"], w["lq_symbols"]], dim=1)
        rel = torch.linalg.vector_norm(gs - ws, dim=1) / torch.clamp(
            torch.linalg.vector_norm(ws, dim=1), min=1e-12)
        sym = max(sym, float(rel.max()))
        neq = gs != ws
        worst_mismatch = max(worst_mismatch, float(neq.float().mean(dim=1).max()))
        differ += int(neq.sum())
        total += neq.numel()
    return {"mask_gap": mask_gap, "decoded_far": far,
            "symbol_mismatch": differ / max(total, 1), "decoded_rmse": rmse,
            "symbol_mismatch_worst": worst_mismatch, "symbol_gap": sym}


def loss_gaps(got: List[Dict[str, float]], want: List[Dict[str, float]]) -> Dict[str, float]:
    """Each step's relative gap of each loss, as {'step.loss': gap}."""
    gaps = {}
    for s, (g, w) in enumerate(zip(got, want)):
        for k in LOSS_KEYS:
            if k in w:
                v = g.get(k, math.nan)
                gap = abs(v - w[k]) / abs(w[k]) if w[k] else abs(v)
                gaps[f"{s}.{k}"] = gap if math.isfinite(gap) else math.inf
    return gaps


def norm_gaps(got: Dict[str, float], want: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's | got - want | / max(want, median of want)."""
    med = float(np.median([want[n] for n in want])) if want else 0.0
    gaps = {}
    for n in want:
        if keep is None or n in keep:
            gap = abs(got.get(n, math.nan) - want[n]) / max(want[n], med, 1e-30)
            gaps[n] = gap if math.isfinite(gap) else math.inf
    return gaps


def worst(gaps: Dict[str, float], k: int = 3) -> List[list]:
    return [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:k]]


def moving_leaves(grads: Dict[str, float], changes: Dict[str, float]) -> set:
    """The leaves held in update_gap: parameters whose first reference
    gradient reaches a thousandth of the median leaf's, and every leaf that
    takes no gradient (BatchNorm statistics)."""
    med = float(np.median(list(grads.values())))
    return {n for n in changes if n not in grads or grads[n] >= GRAD_FLOOR * med}


def training_gaps(got: dict, want: dict, details: dict = None) -> Dict[str, float]:
    """got / want: {"losses": [3 dicts], "grads": {leaf: norm},
    "changes": {leaf: norm}}. `details` (a dict) receives the worst
    entries of each number."""
    keep = moving_leaves(want["grads"], want["changes"])
    losses = loss_gaps(got["losses"], want["losses"])
    first = {k: v for k, v in losses.items()
             if k.startswith("0.") and k[2:] not in AFTER_D_UPDATE}
    parts = {"first_loss_gap": first,
             "loss_gap": losses,
             "grad_gap": norm_gaps(got["grads"], want["grads"]),
             "update_gap": norm_gaps(got["changes"], want["changes"], keep)}
    if details is not None:
        details.update({k: worst(v) for k, v in parts.items()})
        details["update_gap_leaves"] = [len(keep), len(want["changes"])]
    return {k: max(v.values()) if v else math.inf for k, v in parts.items()}


def verdict(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    """correct: every number present, finite and within its limit."""
    return all(k in checks and math.isfinite(checks[k]) and checks[k] <= lim
               for k, lim in limits.items())

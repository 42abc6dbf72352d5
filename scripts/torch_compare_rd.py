#!/usr/bin/env python
"""Overlay rate-distortion results from two or more evaluation runs, with the
flags and the printed markdown of scripts/compare_rd.py.

Each run's `rate_distortion_data.csv` (written by eval/plots.py's
rate-distortion curve: Target BPP, Actual BPP, Measured BPP, PSNR, SSIM,
HQ Ratio (%)) gives one column of a side-by-side markdown table on stdout,
then the PSNR deltas of each run against the first at matched target bpp;
--plot writes an overlay PNG (it needs matplotlib and raises naming it
where matplotlib does not import, after the table is printed).

Usage:
  python scripts/torch_compare_rd.py \
      faithful=runs/r2_faithful/test_results/rate_distortion_data.csv \
      fixed=runs/r3_fixed/test_results/rate_distortion_data.csv \
      --plot runs/r3_fixed/rd_comparison.png

It reads files only, on the host; `device` is accepted so that main(argv,
device) matches the other scripts.
"""

import argparse
import csv
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def load(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [{k: float(v) for k, v in row.items() if v != ""} for row in rows]


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("runs", nargs="+", help="label=path/to/rate_distortion_data.csv")
    ap.add_argument("--plot", default=None, help="write an overlay PNG here")
    args = ap.parse_args(argv)

    series = []
    for spec in args.runs:
        label, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"expected label=path, got {spec!r}")
        series.append((label, load(path)))

    bpps = [r["Target BPP"] for r in series[0][1]]
    print("| Target bpp | " + " | ".join(f"{lbl} PSNR / SSIM / HQ%" for lbl, _ in series) + " |")
    print("|---" * (1 + len(series)) + "|")
    for i, bpp in enumerate(bpps):
        cells = [f"{rows[i]['PSNR']:.2f} dB / {rows[i]['SSIM']:.3f} / "
                 f"{rows[i]['HQ Ratio (%)']:.2f}%" for _, rows in series]
        print(f"| {bpp} | " + " | ".join(cells) + " |")
    base_label, base = series[0]
    for lbl, rows in series[1:]:
        d = [rows[i]["PSNR"] - base[i]["PSNR"] for i in range(len(bpps))]
        print(f"\n{lbl} - {base_label} PSNR delta at matched target bpp: "
              + ", ".join(f"{x:+.2f} dB" for x in d))

    if args.plot:
        from contextual_image_compression_tpu_torch.eval.plots import pyplot

        plt = pyplot()
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        for lbl, rows in series:
            x = [r["Target BPP"] for r in rows]
            axes[0].plot(x, [r["PSNR"] for r in rows], "o-", label=lbl)
            axes[1].plot(x, [r["SSIM"] for r in rows], "o-", label=lbl)
            axes[2].plot(x, [r["HQ Ratio (%)"] for r in rows], "o-", label=lbl)
        for ax, name in zip(axes, ("PSNR (dB)", "SSIM", "HQ ratio (%)")):
            ax.set_xlabel("target bpp")
            ax.set_ylabel(name)
            ax.grid(alpha=0.3)
            ax.legend()
        fig.suptitle("Rate-distortion comparison")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=110)
        print(f"\nwrote {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

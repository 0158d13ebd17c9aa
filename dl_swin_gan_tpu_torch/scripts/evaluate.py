"""Compare `<R>accel.im` reconstructions against the `1accel.im` reference:
per-slice/phase SSIM/RMSE/PSNR, written as CSV with a printed mean and std.

Counterpart of `scripts/evaluate.py` beside the JAX package, with the same
arguments, columns (`ssim,rmse,psnr,name`) and rows; it writes the CSV with
the `csv` module, so it needs no pandas.

    python -m dl_swin_gan_tpu_torch.scripts.evaluate \
        --recon-directory runs/x/recon --acceleration 12
"""

import argparse
import csv
import glob
import logging
import os

import numpy as np

from dl_swin_gan_tpu_torch.infer.evaluate import evaluate_cfl_pair
from dl_swin_gan_tpu_torch.infer.reconstruct import accel_tag

logger = logging.getLogger(__name__)

COLUMNS = ("ssim", "rmse", "psnr", "name")


def evaluate_directory(recon_directory: str, acceleration) -> list:
    """One row per `<name>_<R>accel.im` that has its `<name>_1accel.im`:
    {ssim, rmse, psnr, name}, in the order of the sorted file names."""
    tag = accel_tag(acceleration)
    recons = sorted(glob.glob(os.path.join(
        recon_directory, f"*_{tag}accel.im.hdr")))
    rows = []
    for rpath in recons:
        base = rpath[:-len(".hdr")]
        name = os.path.basename(base).rsplit("_", 1)[0]
        ref = os.path.join(recon_directory, f"{name}_1accel.im")
        if not os.path.exists(ref + ".hdr"):
            logger.warning("no 1accel reference for %s; skipping", name)
            continue
        m = evaluate_cfl_pair(base, ref)
        m["name"] = name
        rows.append(m)
        logger.info("%s: ssim=%.4f rmse=%.5f psnr=%.2f", name,
                    m["ssim"], m["rmse"], m["psnr"])
    return rows


def summary(rows) -> str:
    """The mean and the sample std (ddof 1) of each metric column."""
    names = COLUMNS[:-1]
    vals = np.array([[r[k] for k in names] for r in rows], np.float64)
    std = (vals.std(axis=0, ddof=1) if len(rows) > 1
           else np.full(len(names), np.nan))
    lines = ["      " + "".join(f"{k:>12}" for k in names)]
    for label, v in (("mean", vals.mean(axis=0)), ("std", std)):
        lines.append(f"{label:<6}" + "".join(f"{x:>12.6f}" for x in v))
    return "\n".join(lines)


def write_csv(path: str, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(COLUMNS)
        for r in rows:
            w.writerow([r[k] for k in COLUMNS])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--recon-directory", required=True,
                        help="directory holding <name>_<R>accel.im CFLs")
    parser.add_argument("--acceleration", type=float, required=True)
    parser.add_argument("--output", default=None, help="CSV output path")
    args = parser.parse_args(argv)

    rows = evaluate_directory(args.recon_directory, args.acceleration)
    if not rows:
        logger.error("nothing evaluated")
        return 1
    print(summary(rows))
    out = args.output or os.path.join(
        args.recon_directory, f"eval_{accel_tag(args.acceleration)}accel.csv")
    write_csv(out, rows)
    logger.info("wrote %s", out)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    raise SystemExit(main())

"""Per-slice, per-phase SSIM, RMSE and PSNR of a recon directory, pickled.

Counterpart of the root `scripts/eval.py` (the reference's
`eval.py:16-177`), with its arguments: for every `<name>_<R>accel.im` that
has its `<name>_1accel.im`, `infer/evaluate.py evaluate_volumes` (with the
per-pixel `ssim_image` and `rmse_image` maps unless `--no-maps`; they feed
`eval_recon`'s ROI means), all in one dict {name: metrics} pickled to
`--output` (default `<dir>/eval_<R>accel.pkl`).

    python -m dl_swin_gan_tpu_torch.scripts.eval \\
        --recon-directory runs/x/recon --acceleration 12
"""

import argparse
import glob
import os
import pickle

import numpy as np

from dl_swin_gan_tpu_torch.data import cfl
from dl_swin_gan_tpu_torch.infer.evaluate import evaluate_volumes
from dl_swin_gan_tpu_torch.infer.reconstruct import accel_tag


def load_images(path: str) -> np.ndarray:
    """A recon CFL (scanner order [x, y, slice, emap, phase, ...]) as
    images [slice, emap, phase, y, x]."""
    im = cfl.read(path, order="F")
    im = im.reshape(im.shape[:5])
    return np.transpose(im, (2, 3, 4, 1, 0))


def main(argv=None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("--recon-directory", required=True)
    parser.add_argument("--acceleration", type=float, required=True)
    parser.add_argument("--output", default=None)
    parser.add_argument("--no-maps", action="store_true",
                        help="omit the per-pixel ssim_image/rmse_image maps")
    args = parser.parse_args(argv)

    tag = accel_tag(args.acceleration)
    results = {}
    for hdr in sorted(glob.glob(os.path.join(
            args.recon_directory, f"*_{tag}accel.im.hdr"))):
        base = hdr[:-len(".hdr")]
        name = os.path.basename(base).rsplit("_", 1)[0]
        ref = os.path.join(args.recon_directory, f"{name}_1accel.im")
        if not os.path.exists(ref + ".hdr"):
            continue
        results[name] = evaluate_volumes(load_images(ref), load_images(base),
                                         return_maps=not args.no_maps)

    out = args.output or os.path.join(args.recon_directory,
                                      f"eval_{tag}accel.pkl")
    with open(out, "wb") as f:
        pickle.dump(results, f)
    for name, m in results.items():
        print(f"{name}: ssim={m['ssim'].mean():.4f} "
              f"rmse={m['rmse'].mean():.5f} psnr={m['psnr'].mean():.2f}")
    print(out)
    return out


if __name__ == "__main__":
    main()

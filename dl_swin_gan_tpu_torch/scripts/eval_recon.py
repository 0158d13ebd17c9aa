"""Compare two models' evaluation pickles (`scripts/eval.py`): one row per
exam, the delta, ROI means where the records carry an `roi` mask and the
per-pixel maps, a summary, a Wilcoxon signed-rank test and a scatter plot.

Counterpart of the root `scripts/eval_recon.py` (the reference's
`eval_recon.py:114-357`), with its arguments. It needs pandas; scipy (the
test) and matplotlib (`--out`) where they import.

    python -m dl_swin_gan_tpu_torch.scripts.eval_recon \\
        --pickle-a a/eval_12accel.pkl --pickle-b b/eval_12accel.pkl \\
        --label-a res --label-b swin --out cmp.png
"""

import argparse
import pickle

import numpy as np

from dl_swin_gan_tpu_torch.infer.evaluate import mean_roi


def compare(A: dict, B: dict, label_a: str, label_b: str, metric: str):
    """The per-exam table (a pandas DataFrame indexed by exam) of `metric`
    for the exams in both, with `delta` = B - A, and `<label>_roi` and
    `delta_roi` columns where an `roi` mask and the metric's per-pixel map
    are there (the reference's mean_roi over ssim_image / rmse_image)."""
    import pandas as pd

    map_key = {"ssim": "ssim_image", "rmse": "rmse_image"}.get(metric)
    rows = []
    for name in sorted(set(A) & set(B)):
        row = {"exam": name,
               label_a: float(np.mean(A[name][metric])),
               label_b: float(np.mean(B[name][metric]))}
        roi = A[name].get("roi", B[name].get("roi"))
        if (roi is not None and map_key is not None
                and map_key in A[name] and map_key in B[name]):
            row[f"{label_a}_roi"] = mean_roi(A[name][map_key], roi)
            row[f"{label_b}_roi"] = mean_roi(B[name][map_key], roi)
        rows.append(row)
    df = pd.DataFrame(rows).set_index("exam")
    df["delta"] = df[label_b] - df[label_a]
    if f"{label_a}_roi" in df.columns:
        df["delta_roi"] = df[f"{label_b}_roi"] - df[f"{label_a}_roi"]
    return df


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pickle-a", required=True, help="model A eval pickle")
    parser.add_argument("--pickle-b", required=True, help="model B eval pickle")
    parser.add_argument("--label-a", default="model_a")
    parser.add_argument("--label-b", default="model_b")
    parser.add_argument("--metric", default="ssim",
                        choices=["ssim", "rmse", "psnr"])
    parser.add_argument("--out", default=None, help="plot path (png)")
    args = parser.parse_args(argv)

    with open(args.pickle_a, "rb") as f:
        A = pickle.load(f)
    with open(args.pickle_b, "rb") as f:
        B = pickle.load(f)
    df = compare(A, B, args.label_a, args.label_b, args.metric)
    print(df)
    print("\nsummary:")
    print(df.describe().loc[["mean", "std", "min", "max"]])

    try:
        from scipy.stats import wilcoxon
        stat, pval = wilcoxon(df[args.label_a], df[args.label_b])
    except (ImportError, ValueError):   # no scipy; too few or equal pairs
        pass
    else:
        print(f"\nWilcoxon signed-rank: stat={stat:.3f} p={pval:.4f}")

    if args.out:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(df[args.label_a], df[args.label_b])
        lim = [df.values[:, :2].min(), df.values[:, :2].max()]
        ax.plot(lim, lim, "k--", lw=1)
        ax.set_xlabel(f"{args.label_a} {args.metric}")
        ax.set_ylabel(f"{args.label_b} {args.metric}")
        fig.tight_layout()
        fig.savefig(args.out, dpi=120)
        plt.close(fig)
        print(args.out)
    return df


if __name__ == "__main__":
    main()

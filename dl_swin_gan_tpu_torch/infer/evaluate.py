"""Offline evaluation: SSIM / RMSE / PSNR between reconstructions.

A copy of `infer/evaluate.py` in the JAX package (host-side numpy and
scipy), so both packages score the same images to the same bits. It is the
counterpart of the reference's `evaluate.py` (hand-rolled Gaussian-weighted
windowed SSIM) and `eval.py` (per-slice/phase SSIM + RMSE tables). SSIM is
implemented directly (Wang et al. 2004: 11x11 Gaussian window,
sigma=1.5, K1=0.01, K2=0.03) with scipy convolution — the same definition the
reference's vectorized einsum path computes (evaluate.py:60-128).
"""

from typing import Dict, Optional

import numpy as np
from scipy.ndimage import convolve

from dl_swin_gan_tpu_torch.data import cfl


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def ssim2d(ref: np.ndarray, img: np.ndarray, data_range: Optional[float] = None,
           win_size: int = 11, sigma: float = 1.5,
           full: bool = False):
    """SSIM between two 2D magnitude images (Gaussian-windowed)."""
    ref = np.asarray(ref, np.float64)
    img = np.asarray(img, np.float64)
    if data_range is None:
        data_range = ref.max() - ref.min()
    K1, K2 = 0.01, 0.03
    C1, C2 = (K1 * data_range) ** 2, (K2 * data_range) ** 2
    k = _gaussian_kernel(win_size, sigma)

    mu1 = convolve(ref, k, mode="nearest")
    mu2 = convolve(img, k, mode="nearest")
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = convolve(ref * ref, k, mode="nearest") - mu1_sq
    s2 = convolve(img * img, k, mode="nearest") - mu2_sq
    s12 = convolve(ref * img, k, mode="nearest") - mu12

    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    if full:
        return ssim_map.mean(), ssim_map
    return ssim_map.mean()


def _gaussian_window_ref(ksize, std) -> np.ndarray:
    """Max-normalized separable Gaussian window — twin of reference
    `gaus_2d` (evaluate.py:19-24, scipy.signal.windows.gaussian outer
    product divided by its max)."""
    def g1(M, s):
        n = np.arange(M) - (M - 1) / 2.0
        return np.exp(-(n ** 2) / (2.0 * s ** 2))
    w = np.outer(g1(ksize[1], std), g1(ksize[0], std)).T
    return w / w.max()


def ssim_ref_windowed(recon: np.ndarray, ref: np.ndarray,
                      ksize=(5, 5), win_std: Optional[float] = None,
                      full: bool = False):
    """Exact numpy twin of the reference's hand-rolled windowed SSIM map
    (`evaluate.py:49-66` loop path, the variant stored in its results file
    at `evaluate.py:190-192`): each (unit-peak Gaussian)-weighted sliding
    window contributes ((2·u1·u2+c1)(2·cov+c2)) / ((u1²+u2²+c1)(v1+v2+c2))
    with c1=(0.3·L)², c2=(0.1·L)², L = recon.max()-recon.min() over the
    WHOLE image, and SAMPLE (ddof=1) covariance — np.cov's default, despite
    the reference's "df = 0" comment. The map covers positions
    [0, nx-k0) x [0, ny-k1) (the reference's loop bounds drop the final
    valid window). Vectorized via correlations; parity vs the executed
    reference source is asserted in the JAX package's tests/test_ssim_oracle.py.
    """
    recon = np.asarray(recon, np.float64)
    ref = np.asarray(ref, np.float64)
    k0, k1 = ksize
    if win_std is None:
        win_std = max(k0, k1) / 2.0   # reference main: win_std = max(ksize)/2
    w = _gaussian_window_ref((k0, k1), win_std)
    N = float(k0 * k1)
    L = recon.max() - recon.min()
    c1, c2 = (0.3 * L) ** 2, (0.1 * L) ** 2

    from numpy.lib.stride_tricks import sliding_window_view
    # windows of the w-multiplied images (the reference multiplies the
    # raveled window by the raveled weight, then takes plain statistics)
    w1 = sliding_window_view(recon, (k0, k1))[:-1, :-1] * w
    w2 = sliding_window_view(ref, (k0, k1))[:-1, :-1] * w
    u1 = w1.mean(axis=(-2, -1))
    u2 = w2.mean(axis=(-2, -1))
    # sample covariance/variance: sum(ab) - N*u_a*u_b, over N-1
    cov = ((w1 * w2).sum(axis=(-2, -1)) - N * u1 * u2) / (N - 1)
    v1 = ((w1 * w1).sum(axis=(-2, -1)) - N * u1 * u1) / (N - 1)
    v2 = ((w2 * w2).sum(axis=(-2, -1)) - N * u2 * u2) / (N - 1)
    ssim_map = ((2 * u1 * u2 + c1) * (2 * cov + c2)) / (
        (u1 ** 2 + u2 ** 2 + c1) * (v1 + v2 + c2))
    if full:
        return ssim_map.mean(), ssim_map
    return ssim_map.mean()


def rmse(ref: np.ndarray, img: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.abs(ref - img) ** 2)))


def psnr(ref: np.ndarray, img: np.ndarray) -> float:
    return float(20 * np.log10(np.abs(ref).max() / (rmse(ref, img) + 1e-30)))


def evaluate_volumes(ref: np.ndarray, recon: np.ndarray,
                     roi: Optional[np.ndarray] = None,
                     return_maps: bool = False) -> Dict[str, np.ndarray]:
    """Per-(slice, phase) SSIM/RMSE/PSNR on magnitude images.

    ref/recon: [slices, E, T, Y, X] complex (first emap evaluated, like the
    reference takes emap channel 0/1 — eval.py:23-37). Optional ROI mask
    [Y, X] restricts the comparison (eval_recon.py ROI masking).

    return_maps additionally stores per-pixel metric maps the way the
    reference's eval.py does (`ssim_image` = full SSIM map, eval.py:31;
    `rmse_image` = per-pixel |ref-recon|, eval.py:19-21), each [S, T, Y, X]
    — the inputs of eval_recon.py's ROI means (eval_recon.py:62-70).
    """
    mref = np.abs(ref[:, 0])    # [S, T, Y, X]
    mrec = np.abs(recon[:, 0])
    if roi is not None:
        mref = mref * roi
        mrec = mrec * roi
    S, T = mref.shape[:2]
    out = {k: np.zeros((S, T)) for k in ("ssim", "rmse", "psnr")}
    if return_maps:
        out["ssim_image"] = np.zeros(mref.shape, np.float32)
        out["rmse_image"] = np.abs(mref - mrec).astype(np.float32)
    for s in range(S):
        rng = mref[s].max() - mref[s].min()
        for t in range(T):
            if return_maps:
                val, smap = ssim2d(mref[s, t], mrec[s, t], data_range=rng,
                                   full=True)
                out["ssim"][s, t] = val
                out["ssim_image"][s, t] = smap
            else:
                out["ssim"][s, t] = ssim2d(mref[s, t], mrec[s, t],
                                           data_range=rng)
            out["rmse"][s, t] = rmse(mref[s, t], mrec[s, t])
            out["psnr"][s, t] = psnr(mref[s, t], mrec[s, t])
    return out


def mean_roi(metric_map: np.ndarray, roi: np.ndarray) -> float:
    """Mean of a per-pixel metric map inside an ROI mask — twin of the
    reference's `mean_roi` (eval_recon.py:62-70): boolean-select the masked
    pixels, then one global mean. metric_map: [..., Y, X]; roi: [Y, X]."""
    sel = np.broadcast_to(np.asarray(roi) > 0.5, metric_map.shape)
    return float(np.asarray(metric_map)[sel].mean())


def evaluate_cfl_pair(recon_path: str, ref_path: str) -> Dict[str, float]:
    """Compare a `<R>accel.im` recon against the `1accel.im` reference
    (the reference parity protocol, evaluate.py:160-241)."""

    def load(path):
        im = cfl.read(path, order="F")       # [x, y, sl, emap, ph, 1, 1, 1]
        im = im.reshape(im.shape[:5])
        return np.transpose(im, (2, 3, 4, 1, 0))  # [sl, emap, ph, y, x]

    ref, rec = load(ref_path), load(recon_path)
    per = evaluate_volumes(ref, rec)
    return {k: float(v.mean()) for k, v in per.items()}

"""Variable-density k-t (VDkt) undersampling masks, a frozen copy.

The original dl-swin-gan `subsample.py` VDkt generator, in numpy, so that
the reference makes the serving protocol's mask (one fixed acceleration at
the protocol's seed 1000) without importing the program. The protocol
fixes the mask; training masks are not drawn here: the reference takes
the ones the program drew.
"""

from math import ceil, floor
from typing import Optional, Sequence

import numpy as np

GOLDEN_RATIO = 0.618034


class MaskFunc:
    """Base class: uniformly samples an acceleration rate from a range.

    Reference `MaskFunc` (`subsample.py:13-32`).
    """

    def __init__(self, accelerations: Sequence[float]):
        self.accelerations = accelerations
        self.rng = np.random.RandomState()

    def choose_acceleration(self) -> float:
        lo, hi = self.accelerations[0], self.accelerations[1]
        return lo + (hi - lo) * self.rng.rand()


class VDktMaskFunc(MaskFunc):
    """Variable-density k-t mask with golden-ratio temporal shifts.

    Reference `VDktMaskFunc` (`subsample.py:65-254`); the vdkt core follows
    the Peng Lai (GE, 2018) algorithm: per frame, seed a uniform k-t lattice
    shifted by the golden ratio, perturb sample locations with partial
    adherence to neighbors, re-map through a variable-density warp, then fit
    the warped locations back onto the Cartesian grid from the center out.
    """

    def __init__(self, accelerations, sim_partial_kx: float = 0.25,
                 sim_partial_ky: float = 0.0):
        super().__init__(accelerations)
        self.sim_partial_kx = sim_partial_kx
        self.sim_partial_ky = sim_partial_ky

    def __call__(self, out_shape, seed=None) -> np.ndarray:
        """out_shape is [1, 1, phases, ky, kx] (3D mode); returns float32 mask."""
        nkx, nky, nphases = out_shape[4], out_shape[3], out_shape[2]

        self.rng.seed(seed)
        accel = self.choose_acceleration()

        if self.sim_partial_ky > 0.0:
            mask = self._vdkt_partial_ky(nky, nphases, accel,
                                         partial_factor=self.sim_partial_ky)
        else:
            mask = self._vdkt(nky, nphases, accel)

        # broadcast the ky-t mask across readout; partial echo zeroes the
        # first fraction of kx points (reference only supports the >0 path,
        # subsample.py:107-109 — the ==0 case is fixed here, not ported)
        mask = np.stack(nkx * [mask], axis=0)
        if self.sim_partial_kx > 0.0:
            mask[:int(self.sim_partial_kx * nkx)] = 0

        mask = mask.transpose(2, 1, 0)  # -> [phases, ky, kx]
        return mask.reshape(out_shape).astype(np.float32)

    def _goldenratio_shift(self, accel: float, nt: int) -> np.ndarray:
        return np.round(np.arange(0, nt) * GOLDEN_RATIO * accel) % accel

    def _vdkt(self, ny: int, nt: int, accel: float, nCal: int = 1,
              vdDegree: float = 1.5, vdFactor: Optional[float] = None,
              perturbFactor: float = 0.4, adhereFactor: float = 0.33) -> np.ndarray:
        vdDegree = max(vdDegree, 0.0)
        perturbFactor = min(max(perturbFactor, 0.0), 1.0)
        adhereFactor = min(max(adhereFactor, 0.0), 1.0)
        nCal = max(nCal, 0)

        if vdFactor is None or vdFactor > accel:
            vdFactor = accel

        yCent = floor(ny / 2.0)
        yRadius = (ny - 1) / 2.0

        if vdDegree > 0:
            vdFactor = vdFactor ** (1.0 / vdDegree)
        aCoef = (vdFactor - 1.0) / vdFactor
        bCoef = 1.0 / vdFactor

        ktMask = np.zeros([ny, nt], np.float32)
        ktShift = self._goldenratio_shift(accel, nt)

        for t in range(nt):
            # uniform k-t lattice for this frame
            ySamp = np.arange(ktShift[t], ny, accel)

            # random perturbation, with partial adherence by the neighbors
            if perturbFactor > 0:
                for n in range(ySamp.size):
                    if (ySamp[n] < perturbFactor * accel
                            or ySamp[n] >= ny - perturbFactor * accel):
                        continue
                    dy = perturbFactor * accel * (self.rng.rand() - 0.5)
                    ySamp[n] += dy
                    if n > 0:
                        ySamp[n - 1] += adhereFactor * dy
                    if n < ySamp.size - 1:
                        ySamp[n + 1] += adhereFactor * dy

            ySamp = np.clip(ySamp, 0, ny - 1)
            # variable-density warp toward the k-space center
            ySamp = (ySamp - yRadius) / yRadius
            ySamp = ySamp * (aCoef * np.abs(ySamp) + bCoef) ** vdDegree

            order = np.argsort(np.abs(ySamp))
            ySamp = ySamp[order]
            upper = np.where(ySamp >= 0)[0]
            lower = np.where(ySamp < 0)[0]

            # fit upper half onto the Cartesian grid, center outward
            yAdj = 1.0
            yEdge = floor(ySamp[upper[0]] * yRadius + yRadius + 0.0001)
            yOff = 0.0
            for n in range(upper.size):
                # +0.0001 tolerates floor() numerical error
                yLoc = min(floor((yOff + (ySamp[upper[n]] - yOff) * yAdj)
                                 * yRadius + yRadius + 0.0001), ny - 1)
                if ktMask[yLoc, t] == 0:
                    ktMask[yLoc, t] = 1
                    yEdge = yLoc + 1
                else:
                    ktMask[yEdge, t] = 1
                    yOff = ySamp[upper[n]]
                    yAdj = (yRadius - float(yEdge - yRadius)) / (yRadius * (1 - abs(yOff)))
                    yEdge += 1

            # fit lower half
            yAdj = 1.0
            yEdge = floor(ySamp[lower[0]] * yRadius + yRadius + 0.0001)
            yOff = 0.0
            if ktMask[yEdge, t] == 1:
                yEdge -= 1
                yOff = ySamp[lower[0]]
                yAdj = (yRadius + float(yEdge - yRadius)) / (yRadius * (1.0 - abs(yOff)))
            for n in range(lower.size):
                yLoc = max(floor((yOff + (ySamp[lower[n]] - yOff) * yAdj)
                                 * yRadius + yRadius + 0.0001), 0)
                if ktMask[yLoc, t] == 0:
                    ktMask[yLoc, t] = 1
                    yEdge = yLoc + 1
                else:
                    ktMask[yEdge, t] = 1
                    yOff = ySamp[lower[n]]
                    yAdj = (yRadius - float(yEdge - yRadius)) / (yRadius * (1 - abs(yOff)))
                    yEdge -= 1

        # fully-sampled calibration lines at the center
        ktMask[(yCent - ceil(nCal / 2)):(yCent + nCal - 1 - ceil(nCal / 2)), :] = 1
        return ktMask

    def _vdkt_partial_ky(self, nky: int, nphases: int, tgt_accel: float,
                         partial_factor: float = 0.25, tol: float = 0.1,
                         max_iter: int = 10) -> np.ndarray:
        """Binary search for the vdkt acceleration that, after zeroing
        alternating partial-ky bands, hits the target acceleration.

        Reference `vdkt_partial_ky` (`subsample.py:223-254`).
        """
        lo, hi = 1.0, tgt_accel
        act = 1.0
        mask = None
        it = 0
        while abs(act - tgt_accel) > tol and it < max_iter:
            cur = 0.5 * (lo + hi)
            mask = self._vdkt(nky, nphases, cur)
            nyMask = int(nky * partial_factor)
            mask[(nky - nyMask):nky, 0::2] = 0
            mask[0:nyMask, 1::2] = 0
            act = (nky * nphases) / np.sum(mask)
            if act < tgt_accel:
                lo = cur
            else:
                hi = cur
            it += 1
        return mask

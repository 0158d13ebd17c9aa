"""Device-resident training input pipeline.

Counterpart of `data/device_pipeline.py` in the JAX package. The host
`CinePreprocess` runs numpy complex128 FFTs, a SENSE adjoint and a top-k per
step and ships about 20 MB of k-space, maps and target to the device. Here
the physics runs on the device instead:

  - the raw `kspace` and `maps` of every (file, slice) example are copied to
    the device once, as complex64;
  - per step only the VDkt mask (uint8) and a few augmentation draws cross
    from the host;
  - the FFT crop and flip round trip, the SENSE-adjoint target, the
    95th-percentile normalisation, the sliding-window init and, for DSLR,
    the truncated block SVD run on the device, in the JAX package's order.

The host draws follow `CinePreprocess._augment` and `subsample` call for
call, so seeded (validation) masks, crops and flips are bit-identical to the
host path and to the JAX pipeline. Torch moves complex tensors as they are,
so there is no packing step.
"""

import glob
import logging
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dl_swin_gan_tpu_torch.ops import masks as ss
from dl_swin_gan_tpu_torch.ops.fft import fftc, ifftc
from dl_swin_gan_tpu_torch.ops.llr import BlockOp, decompose
from dl_swin_gan_tpu_torch.ops.sense import sense_adjoint
from dl_swin_gan_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _time_average(data: torch.Tensor, dim: int, eps: float = 1e-6):
    """Torch twin of host_ops.time_average: the mean over the nonzero
    samples along `dim`, kept as a singleton axis."""
    nz = (data.abs() > 1e-12).to(torch.float32)
    return data.sum(dim, keepdim=True) / (nz.sum(dim, keepdim=True) + eps)


def _sliding_window(data: torch.Tensor, window_size: int) -> torch.Tensor:
    """Torch twin of host_ops.sliding_window on axis 2 (circular view
    sharing)."""
    out = []
    for i in range(data.shape[2]):
        shifted = torch.roll(data, int(window_size / 2) - i, dims=2)
        out.append(_time_average(shifted[:, :, :window_size], 2))
    return torch.cat(out, dim=2)


def _maybe_flip(x: torch.Tensor, flag, dim: int) -> torch.Tensor:
    return torch.flip(x, (dim,)) if flag > 0 else x


def _crop(x: torch.Tensor, start: int, size: int, dim: int) -> torch.Tensor:
    """`size` samples of `dim` from `start`. The JAX pipeline's
    dynamic_slice clamps its start; the clipped crop centres keep every
    start in range, so here an out-of-range start is an error."""
    if not 0 <= start <= x.shape[dim] - size:
        raise ValueError(f"crop of {size} from {start} outside an axis of "
                         f"{x.shape[dim]}")
    return x.narrow(dim, start, size)


class DevicePipeline:
    """Builds network-ready batches on `device` from raw examples kept
    there."""

    def __init__(self, cfg, use_seed: bool = False, diffusion: bool = False,
                 lr_decom: bool = False, device=None):
        if diffusion:
            raise NotImplementedError(
                "the device pipeline's diffusion batches (submask_np) are "
                "not ported to the torch package yet: ROADMAP.md Queue 1 "
                "item 10 (diffusion)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_seed = use_seed
        self.lr_decom = lr_decom
        self.rng = np.random.RandomState()
        self.aug = aug = cfg.AUG_TRAIN
        self.mask_func = ss.VDktMaskFunc(
            aug.UNDERSAMPLE.ACCELERATIONS,
            sim_partial_kx=aug.UNDERSAMPLE.PARTIAL_KX,
            sim_partial_ky=aug.UNDERSAMPLE.PARTIAL_KY,
        )
        self.slwin_init = cfg.MODEL.PARAMETERS.SLWIN_INIT

    # -- one-time upload ------------------------------------------------------
    def upload_raw(self, kspace: np.ndarray,
                   maps: np.ndarray) -> Dict[str, torch.Tensor]:
        """One raw example ([C,T,Y,X], [E,C,1,Y,X]) on the device, complex64,
        with a leading batch axis."""
        return {key: torch.from_numpy(np.asarray(a, np.complex64)[None]
                                      ).to(self.device)
                for key, a in (("kspace", kspace), ("maps", maps))}

    # -- per-step host draws (CinePreprocess._augment order) -----------------
    def draw_params(self, fname: str, raw_shape: Tuple[int, ...]) -> Dict:
        """Crop starts, flips and the VDkt mask of one step; raw_shape is
        the raw (uncropped) k-space's [C, T, Y, X]."""
        seed = None if not self.use_seed else tuple(map(ord, fname))
        self.rng.seed(seed)
        _, T, Y, X = raw_shape

        xs = 0
        crop_x = self.aug.CROP_READOUT
        if crop_x > 0:
            center = int(self.rng.normal(loc=X // 2 + 1, scale=crop_x // 2))
            center = int(np.clip(center, crop_x // 2, X - crop_x // 2 - 1))
            xs = center - crop_x // 2 + 1
            X = crop_x
        ys = 0
        crop_y = self.aug.ZPAD_PE
        if crop_y > 0:
            center = int(self.rng.normal(loc=Y // 2 + 1, scale=crop_y // 2))
            center = int(np.clip(center, crop_y // 2, Y - crop_y // 2 - 1))
            ys = center - crop_y // 2 + 1
            Y = crop_y
        flips = np.asarray([self.rng.rand() > 0.5 for _ in range(3)],
                           np.float32)
        mask = self.mask_func((1, 1, T, Y, X), seed).astype(np.uint8)
        return dict(xs=np.int32(xs), ys=np.int32(ys), flips=flips, mask=mask)

    # -- the device build ------------------------------------------------------
    def build(self, raw: Dict[str, torch.Tensor],
              params: Dict) -> Dict[str, torch.Tensor]:
        """One batch (leading axis 1, the keys of Trainer.batch_keys) on the
        device from a raw example and its host draws."""
        kspace, maps = raw["kspace"], raw["maps"]   # [1,C,T,Y,X], [1,E,C,1,Y,X]

        multicoil = ifftc(kspace)
        crop_x = self.aug.CROP_READOUT
        if crop_x > 0:
            multicoil = _crop(multicoil, int(params["xs"]), crop_x, -1)
            maps = _crop(maps, int(params["xs"]), crop_x, -1)
        crop_y = self.aug.ZPAD_PE
        if crop_y > 0:
            multicoil = _crop(multicoil, int(params["ys"]), crop_y, -2)
            maps = _crop(maps, int(params["ys"]), crop_y, -2)
        flips = params["flips"]
        multicoil = _maybe_flip(multicoil, flips[0], -1)
        maps = _maybe_flip(maps, flips[0], -1)
        multicoil = _maybe_flip(multicoil, flips[1], -2)
        maps = _maybe_flip(maps, flips[1], -2)
        multicoil = _maybe_flip(multicoil, flips[2], -3)  # time; maps static
        kspace = fftc(multicoil)

        target = sense_adjoint(kspace, maps)
        mask = torch.from_numpy(params["mask"]).to(self.device).to(
            torch.float32)
        masked_kspace = kspace * mask

        # 95th-percentile magnitude normalisation: the k-th largest of the
        # time-averaged adjoint's magnitude (np.partition's value on the
        # host; a quantile would interpolate)
        averaged = _time_average(masked_kspace, 2)
        magnitude = sense_adjoint(averaged, maps).abs().reshape(-1)
        k = int(round(0.05 * magnitude.numel()))
        scale = (torch.topk(magnitude, k).values[-1] if k > 0
                 else magnitude.max())

        masked_kspace = masked_kspace / scale
        target = target / scale
        init_kspace = (_sliding_window(masked_kspace, 5) if self.slwin_init
                       else masked_kspace)
        init_image = sense_adjoint(init_kspace, maps)

        out = dict(kspace=masked_kspace, mask=mask, maps=maps,
                   init_image=init_image,
                   scale=scale.to(torch.float32).reshape(1), target=target)
        if self.lr_decom:
            # DSLR's L0/R0 from a truncated SVD of the init image's blocks.
            # SVD factor phases differ between libraries; L R^H does not
            p = self.cfg.MODEL.PARAMETERS
            op = BlockOp(p.DSLR.BLOCK_SIZE, init_image.shape,
                         overlapping=p.DSLR.OVERLAPPING, device=self.device)
            L, R = decompose(op.extract(init_image), p.DSLR.NUM_BASIS)
            out["L_init"] = L[None].to(torch.complex64)
            out["R_init"] = R[None].to(torch.complex64)
        return out


class DevicePipelineLoader:
    """In place of a dataset and `DataLoader`: yields batches built on the
    device, batch size 1. Every (file, slice) example is copied to the
    device once, at construction; each epoch reshuffles as the JAX
    package's loader does (`random.Random(seed + epoch)`).

    The examples come from the .h5 files of `root_directory`, or from
    `files`, records held in memory as `data.synthetic.quality_split` makes
    them: (name, kspace [S,C,T,Y,X], maps [S,E,C,1,Y,X], target).
    """

    def __init__(self, root_directory: Optional[str], cfg, seed: int,
                 lr_decom: bool = False, sample_rate: float = 1.0,
                 files=None, device=None):
        self.pipe = DevicePipeline(cfg, lr_decom=lr_decom, device=device)
        self.seed = seed
        self._epoch = 0
        self._raw: List[Dict[str, torch.Tensor]] = []
        self._names: List[str] = []
        self._shapes: List[Tuple[int, ...]] = []
        total = 0
        for name, k, m in self._examples(root_directory, files, sample_rate):
            self._raw.append(self.pipe.upload_raw(k, m))
            self._names.append(name)
            self._shapes.append(tuple(k.shape))
            total += k.nbytes + m.nbytes
        logger.info("device pipeline: %d examples (%.0f MB) on %s",
                    len(self._raw), total / 1e6, self.pipe.device)

    @staticmethod
    def _examples(root_directory, files, sample_rate):
        """(name, kspace, maps) of every slice, in Hdf5Dataset's order."""
        if files is not None:
            for name, kspace, maps, _ in files:
                for s in range(len(kspace)):
                    yield name, kspace[s], maps[s]
            return
        import h5py
        paths = glob.glob(os.path.join(root_directory, "*.h5"))
        if sample_rate < 1.0:
            random.shuffle(paths)
            paths = paths[:round(len(paths) * sample_rate)]
        for filename in sorted(paths):
            with h5py.File(filename, "r") as f:
                for s in range(f["kspace"].shape[0]):
                    yield filename, f["kspace"][s], f["maps"][s]

    def __len__(self) -> int:
        return len(self._raw)

    def __iter__(self):
        idx = list(range(len(self._raw)))
        random.Random(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        for i in idx:
            params = self.pipe.draw_params(self._names[i], self._shapes[i])
            yield self.pipe.build(self._raw[i], params)

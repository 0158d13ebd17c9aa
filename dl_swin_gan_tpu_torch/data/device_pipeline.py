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
    the truncated block SVD run on the device, in the JAX package's order;
  - for diffusion (DDPM_X) the host also draws the 90/10 split of the
    acquired lines (`submask_np`, from its own RandomState(SEED + 99), or
    from the example's key under a `draw_seed`) right after the mask, and the batch carries `mask_r` and `mask_p` and no raw
    k-space, which the diffusion paths never read.

The host draws follow `CinePreprocess._augment` and `subsample` call for
call, so seeded (validation) masks, crops and flips are bit-identical to the
host path and to the JAX pipeline. Training draws are unseeded, as in the
JAX package, unless a `draw_seed` N is given: then the k-th draw of the
pipeline (its crop, flips and VDkt mask) is seeded from (N, k), so a run
can be repeated (`scripts/quality_row.py --draw-seed`). Torch moves
complex tensors as they are, so there is no packing step.
"""

import glob
import logging
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dl_swin_gan_tpu_torch.data.host_ops import keyed_submask_rng, submask_np
from dl_swin_gan_tpu_torch.ops import masks as ss
from dl_swin_gan_tpu_torch.ops.fft import fftc, ifftc
from dl_swin_gan_tpu_torch.ops.llr import BlockOp, decompose
from dl_swin_gan_tpu_torch.ops.sense import sense_adjoint
from dl_swin_gan_tpu_torch.ops.utils import sliding_window, time_average
from dl_swin_gan_tpu_torch.parallel.mesh import RankBatch
from dl_swin_gan_tpu_torch.utils.device import resolve_device
from dl_swin_gan_tpu_torch.utils.tracing import span

logger = logging.getLogger(__name__)


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
                 lr_decom: bool = False, device=None,
                 draw_seed: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_seed = use_seed
        self.draw_seed = draw_seed
        self.draws = 0
        self.diffusion = diffusion
        self.lr_decom = lr_decom
        self.rng = np.random.RandomState()
        self.submask_rng = np.random.RandomState(cfg.SEED + 99)
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
        with span("pipeline.draw"):
            seed = None if not self.use_seed else tuple(map(ord, fname))
            keyed = seed is None and self.draw_seed is not None
            if keyed:
                seed = (self.draw_seed, self.draws)
                self.draws += 1
            self.rng.seed(seed)
            _, T, Y, X = raw_shape

            xs = 0
            crop_x = self.aug.CROP_READOUT
            if crop_x > 0:
                center = int(self.rng.normal(loc=X // 2 + 1,
                                             scale=crop_x // 2))
                center = int(np.clip(center, crop_x // 2,
                                     X - crop_x // 2 - 1))
                xs = center - crop_x // 2 + 1
                X = crop_x
            ys = 0
            crop_y = self.aug.ZPAD_PE
            if crop_y > 0:
                center = int(self.rng.normal(loc=Y // 2 + 1,
                                             scale=crop_y // 2))
                center = int(np.clip(center, crop_y // 2,
                                     Y - crop_y // 2 - 1))
                ys = center - crop_y // 2 + 1
                Y = crop_y
            flips = np.asarray([self.rng.rand() > 0.5 for _ in range(3)],
                               np.float32)
            mask = self.mask_func((1, 1, T, Y, X), seed).astype(np.uint8)
            out = dict(xs=np.int32(xs), ys=np.int32(ys), flips=flips,
                       mask=mask)
            if self.diffusion and \
                    self.cfg.MODEL.META_ARCHITECTURE.lower() == "ddpm_x":
                mask_r, mask_p = submask_np(
                    mask.astype(np.float32), 0.9,
                    keyed_submask_rng(seed) if keyed else self.submask_rng)
                out["mask_r"] = mask_r.astype(np.uint8)
                out["mask_p"] = mask_p.astype(np.uint8)
            return out

    # -- the device build ------------------------------------------------------
    def build(self, raw: Dict[str, torch.Tensor],
              params: Dict) -> Dict[str, torch.Tensor]:
        """One batch (leading axis 1, the keys of Trainer.batch_keys) on the
        device from a raw example and its host draws."""
        with span("pipeline.build"):
            # [1,C,T,Y,X], [1,E,C,1,Y,X]
            kspace, maps = raw["kspace"], raw["maps"]

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
            # time; maps static
            multicoil = _maybe_flip(multicoil, flips[2], -3)
            kspace = fftc(multicoil)

            target = sense_adjoint(kspace, maps)
            mask = torch.from_numpy(params["mask"]).to(self.device).to(
                torch.float32)
            masked_kspace = kspace * mask

            # 95th-percentile magnitude normalisation: the k-th largest of
            # the time-averaged adjoint's magnitude (np.partition's value on
            # the host; a quantile would interpolate)
            averaged = time_average(masked_kspace, 2)
            magnitude = sense_adjoint(averaged, maps).abs().reshape(-1)
            k = int(round(0.05 * magnitude.numel()))
            scale = (torch.topk(magnitude, k).values[-1] if k > 0
                     else magnitude.max())

            masked_kspace = masked_kspace / scale
            target = target / scale
            init_kspace = (sliding_window(masked_kspace, 2, 5)
                           if self.slwin_init else masked_kspace)
            init_image = sense_adjoint(init_kspace, maps)

            out = dict(kspace=masked_kspace, mask=mask, maps=maps,
                       init_image=init_image,
                       scale=scale.to(torch.float32).reshape(1),
                       target=target)
            if self.diffusion:
                del out["kspace"]
                for key in ("mask_r", "mask_p"):
                    out[key] = (torch.from_numpy(params[key]).to(
                        self.device).to(torch.float32) if key in params
                        else mask)
            if self.lr_decom:
                # DSLR's L0/R0 from a truncated SVD of the init image's
                # blocks. SVD factor phases differ between libraries; L R^H
                # does not
                p = self.cfg.MODEL.PARAMETERS
                op = BlockOp(p.DSLR.BLOCK_SIZE, init_image.shape,
                             overlapping=p.DSLR.OVERLAPPING,
                             device=self.device)
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

    `shard` (index, count): a data-parallel rank's loader. A global batch
    is `count` consecutive examples of the epoch's order, and this rank
    builds the index-th (a `RankBatch` of one); with a `draw_seed` its
    draws are keyed by that example's global position, as in the
    one-rank run.
    """

    def __init__(self, root_directory: Optional[str], cfg, seed: int,
                 lr_decom: bool = False, sample_rate: float = 1.0,
                 files=None, device=None, diffusion: bool = False,
                 draw_seed: Optional[int] = None,
                 shard: Tuple[int, int] = (0, 1)):
        self.pipe = DevicePipeline(cfg, lr_decom=lr_decom, device=device,
                                   diffusion=diffusion, draw_seed=draw_seed)
        self.shard = shard
        if shard[1] > 1:    # unseeded DDPM_X splits: a stream of the rank's
            self.pipe.submask_rng = np.random.RandomState(
                [cfg.SEED + 99, shard[0]])
        self._drawn = 0
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
        return len(self._raw) // self.shard[1]

    def __iter__(self):
        idx = list(range(len(self._raw)))
        random.Random(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        index, count = self.shard
        for j in range(len(self)):
            i = idx[j * count + index]
            if count > 1:
                self.pipe.draws = self._drawn + index
            self._drawn += count
            params = self.pipe.draw_params(self._names[i], self._shapes[i])
            batch = self.pipe.build(self._raw[i], params)
            yield RankBatch(batch) if count > 1 else batch

"""Compact-transfer serving: ship only the acquired k-space lines.

Counterpart of `infer/compact.py` in the JAX package. The dense path
(`Reconstructor` fed by `ResampleTransform`) copies the whole k-space grid
and the initial image of every slice to the device, although at 12x only
about 1/12 of the ky-t grid is acquired and the rest is zeros. Here:

  host   - `CompactTransform` re-undersamples (the port's VDkt at the parity
           seed) and packs the acquired ky lines of each frame into
           [C, T, n_max, X], with int32 line indices and a validity mask:
           the wire format a scanner would send (`pack_lines`, numpy, a copy
           of the JAX package's);
  device - `CompactReconstructor` scatters the lines back onto the dense
           grid, takes the sampling mask from coil 0's nonzero pattern (the
           reference's get_mask convention), runs the 95%-max normalisation
           and the sliding-window init (the twins of `infer/transforms.py`),
           and the unrolled solver, whose SENSE normal op launches the
           hand-written kernel.

`FlatWire` puts a slice's arrays into one 1-D buffer, float32 (lossless) or
float16 (half the bytes; indices exact up to 2048), so that a slice crosses
the link in one copy. The outputs match the dense path's to float32
round-off (tests/test_torch_compact.py).
"""

import numpy as np
import torch

from dl_swin_gan_tpu_torch.convert import init_params
from dl_swin_gan_tpu_torch.infer.transforms import PARITY_SEED
from dl_swin_gan_tpu_torch.ops import masks as ss
from dl_swin_gan_tpu_torch.ops.sense import sense_adjoint
from dl_swin_gan_tpu_torch.ops.utils import sliding_window, time_average
from dl_swin_gan_tpu_torch.solvers import build_solver
from dl_swin_gan_tpu_torch.utils.device import resolve_device, use_ieee_fp32

# the arrays of one packed example, in the dict wire's order
WIRE_KEYS = ("kspace_lines", "line_idx", "line_valid", "maps")


def pack_lines(kspace: np.ndarray, n_max=None):
    """Pack acquired ky lines of masked k-space [C, T, Y, X].

    Returns (packed [C, T, n, X] complex64, idx [T, n] int32,
    valid [T, n] float32). A line is "acquired" when any coil/readout
    sample on it is nonzero; partial-kx zeros ride inside the packed line.
    """
    kspace = np.asarray(kspace)
    C, T, Y, X = kspace.shape
    acquired = (np.abs(kspace) > 1e-12).any(axis=(0, 3))  # [T, Y]
    counts = acquired.sum(1)
    n = int(counts.max() if n_max is None else n_max)
    if counts.max() > n:
        raise ValueError(
            f"n_max={n} < max acquired lines per frame ({counts.max()})")
    idx = np.zeros((T, n), np.int32)
    valid = np.zeros((T, n), np.float32)
    for t in range(T):
        ys = np.flatnonzero(acquired[t])
        idx[t, :len(ys)] = ys
        valid[t, :len(ys)] = 1.0
    packed = kspace[:, np.arange(T)[:, None], idx, :]
    packed = packed * valid[None, :, :, None]
    return packed.astype(np.complex64), idx, valid


def pad_lines(example: dict, n_max: int) -> dict:
    """Pad a packed example's line dimension to n_max (for batching)."""
    n = example["line_idx"].shape[-1]
    if n == n_max:
        return example
    pad = n_max - n
    out = dict(example)
    out["kspace_lines"] = np.pad(example["kspace_lines"],
                                 ((0, 0), (0, 0), (0, pad), (0, 0)))
    out["line_idx"] = np.pad(example["line_idx"], ((0, 0), (0, pad)))
    out["line_valid"] = np.pad(example["line_valid"], ((0, 0), (0, pad)))
    return out


def unpack_lines(packed: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                 ny: int) -> torch.Tensor:
    """Device twin of pack_lines: [B, C, T, n, X] -> dense [B, C, T, Y, X].

    Invalid (padded) entries carry zero data and scatter-add into row
    idx = 0, contributing nothing: the scatter accumulates, so a padded
    entry never overwrites an acquired row 0 of its frame.
    """
    B, C, T, n, X = packed.shape
    p = packed * valid[:, None, :, :, None].to(packed.dtype)
    values = torch.view_as_real(p.permute(0, 2, 3, 1, 4).contiguous())
    dense = torch.zeros((B, T, ny, C, X, 2), dtype=values.dtype,
                        device=values.device)
    b = torch.arange(B, device=idx.device)[:, None, None]
    t = torch.arange(T, device=idx.device)[None, :, None]
    dense.index_put_((b, t, idx.long()), values, accumulate=True)
    return torch.view_as_complex(dense).permute(0, 3, 1, 2, 4).contiguous()


def wire_bytes(example) -> int:
    """Bytes this example moves over the host->device link."""
    if isinstance(example, np.ndarray):
        return example.nbytes
    return sum(np.asarray(v).nbytes for v in example.values())


class FlatWire:
    """One-transfer wire codec for the compact path: every array of a slice
    in one contiguous 1-D buffer (complex arrays as stacked re/im planes),
    sliced and reshaped back on the device.

    dtype float32 is lossless (ky line indices are exact as floats up to
    2**24). float16 halves the payload: indices stay exact up to 2048
    (checked at encode), validity is 0/1, and the k-space and map samples
    round to about 1e-3 relative.
    """

    def __init__(self, template: dict, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        k = np.asarray(template["kspace_lines"])
        i = np.asarray(template["line_idx"])
        v = np.asarray(template["line_valid"])
        m = np.asarray(template["maps"])
        # (name, stored shape, complex?): re/im planes stack on axis 0
        self._segs = [
            ("kspace_lines", (2,) + k.shape, True),
            ("line_idx", i.shape, False),
            ("line_valid", v.shape, False),
            ("maps", (2,) + m.shape, True),
        ]
        self._sizes = [int(np.prod(s)) for _, s, _ in self._segs]
        self._offsets = np.cumsum([0] + self._sizes[:-1]).tolist()
        self.length = int(sum(self._sizes))

    def encode(self, example: dict) -> np.ndarray:
        """Host side: example dict -> one 1-D buffer of self.dtype."""
        idx = np.asarray(example["line_idx"])
        if self.dtype.itemsize < 4 and idx.size and idx.max() > 2048:
            raise ValueError("float16 wire: line indices exceed 2048, "
                             "not exactly representable")
        buf = np.empty(self.length, self.dtype)
        for (name, shape, cplx), size, off in zip(
                self._segs, self._sizes, self._offsets):
            a = np.asarray(example[name])
            flat = (np.stack([a.real, a.imag]) if cplx else a).ravel()
            buf[off:off + size] = flat.astype(self.dtype)
        return buf

    def decode(self, buf: torch.Tensor) -> dict:
        """Device side: [B, length] -> the example dict of tensors."""
        out = {}
        B = buf.shape[0]
        for (name, shape, cplx), size, off in zip(
                self._segs, self._sizes, self._offsets):
            seg = buf[:, off:off + size].reshape((B,) + shape)
            seg = seg.to(torch.float32)
            if cplx:
                out[name] = torch.complex(seg[:, 0], seg[:, 1])
            elif name == "line_idx":
                out[name] = seg.round().to(torch.int32)
            else:
                out[name] = seg
        return out


class CompactTransform:
    """Host side of the compact path: (re)undersample and pack the lines,
    nothing else. The normalisation and the sliding-window init run on the
    device in `CompactReconstructor`, so neither the dense k-space nor the
    initial image crosses the link.

    acceleration > 1: re-undersample fully-sampled data at the parity seed
    (the reference's reconstruct_h5 protocol). acceleration None or 1: the
    input is already undersampled scanner data; apply_fftmod=True for raw
    CFL.
    """

    def __init__(self, cfg, acceleration=None, n_max=None,
                 seed: int = PARITY_SEED, apply_fftmod: bool = False):
        self.n_max = n_max
        self.seed = seed
        self.apply_fftmod = apply_fftmod
        self.mask_func = None
        if acceleration is not None and acceleration > 1:
            self.mask_func = ss.VDktMaskFunc(
                (acceleration, acceleration),
                sim_partial_kx=cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KX,
                sim_partial_ky=cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY,
            )

    def __call__(self, kspace: np.ndarray, maps: np.ndarray) -> dict:
        kspace = np.asarray(kspace)
        maps = np.asarray(maps)
        if self.apply_fftmod:
            from dl_swin_gan_tpu_torch.data import host_ops as H
            kspace = H.fftmod(kspace)
            maps = H.fftmod(maps)
        if self.mask_func is not None:
            kspace, _ = ss.subsample(kspace[None], self.mask_func,
                                     seed=self.seed, mode="3D")
            kspace = kspace[0]
        packed, idx, valid = pack_lines(kspace, self.n_max)
        return dict(kspace_lines=packed, line_idx=idx, line_valid=valid,
                    maps=maps.astype(np.complex64))


class CompactReconstructor:
    """The dense-grid rebuild, normalisation, init and unrolled solver on
    `device` (the GPU when none is given), under inference mode with TF32
    off, as `Reconstructor` runs.

    ny: the dense ky grid size (packed batches carry only indices). The
    output matches `Reconstructor` fed by the dense transforms to float32
    round-off, in input units. `params` is a state_dict
    (`convert.init_params`, `convert.flax_to_torch`), or None to set later
    through the `params` attribute.

    wire: None for the dict wire (a dict of stacked packed examples), or a
    `FlatWire`: then `__call__` takes a [B, wire.length] buffer and each
    slice crosses the link in one copy.
    """

    def __init__(self, cfg, params, ny: int, wire: FlatWire = None,
                 device=None):
        self.cfg = cfg
        self.ny = ny
        self.wire = wire
        self.slwin = cfg.MODEL.PARAMETERS.SLWIN_INIT
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_ieee_fp32()
        self.model = build_solver(cfg)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.to(self.device).eval()

    @property
    def params(self) -> dict:
        return self.model.state_dict()

    @params.setter
    def params(self, params: dict) -> None:
        self.model.load_state_dict(params)

    def init_params(self, batch: dict = None, seed: int = 0) -> dict:
        """Seeded torch-default weights of the config's solver (bench and
        test use); torch needs no batch to size them."""
        return init_params(self.cfg, seed)

    def to_device(self, batch) -> dict:
        """The wire's arrays on the device: a dict of stacked packed
        examples, or a [B, wire.length] buffer (float16 stays float16)."""
        if self.wire is not None:
            buf = torch.from_numpy(np.ascontiguousarray(batch))
            return {"buf": buf.to(self.device)}
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
            self.device) for k in WIRE_KEYS}

    @torch.inference_mode()
    def reconstruct(self, b: dict) -> torch.Tensor:
        """Wire arrays on the device -> complex images [B, E, T, Y, X] on
        the device, in input units."""
        if self.wire is not None:
            b = self.wire.decode(b["buf"])
        kspace = unpack_lines(b["kspace_lines"], b["line_idx"],
                              b["line_valid"], self.ny)
        maps = b["maps"]
        # the sampling mask from the nonzero pattern of coil 0 (the
        # reference's get_mask, infer/transforms.py)
        mask = (kspace[:, :1].abs() > 1e-12).to(torch.float32)

        # 95%-max normalisation, per example: the k-th largest magnitude
        # of the time-averaged adjoint (the host path's np.partition)
        image = sense_adjoint(time_average(kspace, 2), maps)
        nb = image.shape[0]
        mag = image.abs().reshape(nb, -1)
        k = int(round(0.05 * mag.shape[1]))
        scale = (torch.topk(mag, k, dim=1).values[:, -1] if k > 0
                 else mag.amax(dim=1))
        kspace = kspace / scale.reshape((nb,) + (1,) * (kspace.ndim - 1))

        init_kspace = sliding_window(kspace, 2, 5) if self.slwin else kspace
        init_image = sense_adjoint(init_kspace, maps)
        pred = self.model(kspace, maps, mask, x0=init_image)
        return pred * scale.reshape((nb,) + (1,) * (pred.ndim - 1))

    def __call__(self, batch) -> np.ndarray:
        """batch: dict of stacked packed examples (dict wire) or an encoded
        [B, wire.length] buffer (flat wire) -> complex64 images."""
        out = self.reconstruct(self.to_device(batch))
        return out.cpu().numpy().astype(np.complex64)

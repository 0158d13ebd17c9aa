"""Complex linear-operator core: FFTs, SENSE operators, VDkt masks; image
metrics. The LLR block operators (`ops.llr`) and conjugate gradient
(`ops.cg`) are imported from their modules."""

from dl_swin_gan_tpu_torch.ops import masks, metrics
from dl_swin_gan_tpu_torch.ops.fft import fftc, fftmod, ifftc
from dl_swin_gan_tpu_torch.ops.sense import (
    SenseOp, sense_adjoint, sense_forward, sense_normal,
)

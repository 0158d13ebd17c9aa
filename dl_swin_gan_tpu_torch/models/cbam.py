"""CBAM ResNet: counterpart of `models/cbam.py` in the JAX package (the
reference's CBAM.py)."""

from dl_swin_gan_tpu_torch.models.resnet import GatedResNet3D


class CBAMResNet3D(GatedResNet3D):
    def __init__(self, **kwargs):
        super().__init__(gate="cbam", **kwargs)

"""Squeeze-excitation ResNet: counterpart of `models/se.py` in the JAX
package (the reference's se3d.py)."""

from dl_swin_gan_tpu_torch.models.resnet import GatedResNet3D


class SEResNet3D(GatedResNet3D):
    def __init__(self, **kwargs):
        super().__init__(gate="se", **kwargs)

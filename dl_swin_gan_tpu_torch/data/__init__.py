"""Host-side data: CFL IO, numpy operator twins, synthetic phantoms."""

from dl_swin_gan_tpu_torch.data import cfl, host_ops
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example, write_synthetic_dataset

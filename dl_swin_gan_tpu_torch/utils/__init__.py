from dl_swin_gan_tpu_torch.utils.device import resolve_device, use_ieee_fp32
from dl_swin_gan_tpu_torch.utils.headline import headline_cfg, headline_shape
from dl_swin_gan_tpu_torch.utils.folder_param import (
    folder_to_parameter, parameter_to_folder,
)

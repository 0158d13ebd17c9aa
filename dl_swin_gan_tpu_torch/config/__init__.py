from dl_swin_gan_tpu_torch.config.config import CfgNode, get_cfg, load_cfg

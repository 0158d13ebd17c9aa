from dl_swin_gan_tpu_torch.infer.transforms import (
    PARITY_SEED, InferenceTransform, ResampleTransform,
)
from dl_swin_gan_tpu_torch.infer.reconstruct import Reconstructor, reconstruct_h5_file

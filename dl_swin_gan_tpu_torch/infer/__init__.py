from dl_swin_gan_tpu_torch.infer.transforms import (
    PARITY_SEED, InferenceTransform, ResampleTransform,
)
from dl_swin_gan_tpu_torch.infer.reconstruct import (
    Reconstructor, load_checkpoint_params, reconstruct_cfl, reconstruct_h5_file,
)

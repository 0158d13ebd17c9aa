from dl_swin_gan_tpu_torch.infer.transforms import (
    PARITY_SEED, InferenceTransform, ResampleTransform,
)
from dl_swin_gan_tpu_torch.infer.reconstruct import (
    DiffusionReconstructor, LRReconstructor, Reconstructor,
    load_checkpoint_params, make_reconstructor, reconstruct_cfl,
    reconstruct_exam, reconstruct_h5_file,
)

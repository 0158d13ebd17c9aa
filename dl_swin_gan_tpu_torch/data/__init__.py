"""Host-side data: CFL IO, numpy operator twins, synthetic phantoms, the
training preprocess, the HDF5 and in-memory datasets and their loader."""

from dl_swin_gan_tpu_torch.data import cfl, host_ops
from dl_swin_gan_tpu_torch.data.dataset import (
    DataLoader, Hdf5Dataset, InMemoryDataset,
)
from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
from dl_swin_gan_tpu_torch.data.synthetic import (
    make_cine_example, quality_split, write_synthetic_dataset,
)

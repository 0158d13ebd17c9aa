"""Device choice and float32 precision for the port's entry points."""

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the given one, else the GPU; in
    a process torchrun started, this rank's GPU, cuda:LOCAL_RANK.

    There is no silent CPU fallback: with no CUDA device the caller must ask
    for ``device="cpu"`` explicitly.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda")


def use_ieee_fp32() -> None:
    """Run float32 convolutions and matmuls in full float32, never TF32.

    The JAX reference computes in true float32, and TF32 keeps about three
    decimal digits, which the parity tolerances would not absorb. cuDNN
    convolutions default to TF32, so both flags are set here, in one place,
    by every entry point that runs on the GPU.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

"""Weights for the torch solver: converted from the JAX package's param tree,
or drawn from a seeded torch-default init.

The JAX tree of a RES/pgd `UnrolledSolver` (nested dicts of arrays):

    ResNet3D_{i}/ConvBlock_0/Conv_0/Conv_0/{kernel [kt,ky,kx,2E,F], bias [F]}
    ResNet3D_{i}/GatedResBlock_{j}/ConvBlock_{0,1}/Conv_0/Conv_0/{kernel, bias}
    ResNet3D_{i}/ConvBlock_1/Conv_0/Conv_0/{kernel [kt,ky,kx,F,2E], bias}
    step_size [1]

maps to `nets.{i}.head`, `nets.{i}.blocks.{j}.conv{0,1}`, `nets.{i}.tail`
and `step_size`. Kernels go from [kt, ky, kx, Cin, Cout] to torch's
[Cout, Cin, kt, ky, kx]; the input channel order [re_0..re_{E-1},
im_0..im_{E-1}] is the same on both sides.
"""

from typing import Dict, Mapping

import numpy as np
import torch

from dl_swin_gan_tpu_torch.solvers import build_solver


def _conv(block: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    leaf = block["Conv_0"]["Conv_0"]
    if set(leaf) != {"kernel", "bias"}:
        raise KeyError(f"{prefix}: expected a real conv (kernel, bias), got "
                       f"{sorted(leaf)}")
    kernel = np.asarray(leaf["kernel"], dtype=np.float32)
    return {
        f"{prefix}.conv.weight": torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(4, 3, 0, 1, 2))),
        f"{prefix}.conv.bias": torch.from_numpy(
            np.asarray(leaf["bias"], dtype=np.float32).copy()),
    }


def _resnet(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for name, node in tree.items():
        if name == "ConvBlock_0":
            out.update(_conv(node, f"{prefix}.head"))
        elif name == "ConvBlock_1":
            out.update(_conv(node, f"{prefix}.tail"))
        elif name.startswith("GatedResBlock_"):
            j = int(name.rsplit("_", 1)[1])
            for k in (0, 1):
                out.update(_conv(node[f"ConvBlock_{k}"],
                                 f"{prefix}.blocks.{j}.conv{k}"))
        else:
            raise KeyError(f"{prefix}: no torch counterpart for {name}")
    return out


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `UnrolledSolver` params (RES denoiser, pgd) -> torch state_dict."""
    state = {}
    for name, node in params.items():
        if name == "step_size":
            state["step_size"] = torch.from_numpy(
                np.asarray(node, dtype=np.float32).reshape(1).copy())
        elif name.startswith("ResNet3D_"):
            i = int(name.rsplit("_", 1)[1])
            state.update(_resnet(node, f"nets.{i}"))
        else:
            raise KeyError(f"no torch counterpart for param {name}")
    return state


def init_params(cfg, seed: int) -> Dict[str, torch.Tensor]:
    """A seeded torch-default init of the solver the config describes."""
    gen = torch.Generator().manual_seed(seed)
    return build_solver(cfg, generator=gen).state_dict()

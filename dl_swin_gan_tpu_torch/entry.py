"""Entry points: the flagship forward step, and a multi-rank dry run.

Counterpart of `__graft_entry__.py` beside the JAX package.

    entry() -> (fn, args): fn(*args) is the forward step (reconstruction)
        of configs/basic/example.yaml's unrolled ResNet (5 unrolls x 2
        resblocks x 64 features) on a synthetic batch, on the GPU.
    dryrun_multichip(n, backend): n ranks (`parallel/launch.py`) over a
        (data x fsdp) mesh, each running ONE train step of the unrolled
        Trainer, the bf16 DiT DiffusionTrainer, the GANTrainer and the
        DSLRTrainer at toy widths on its slice of the batch; with n a
        multiple of 4, also the DiT step with the tensor-parallel plan on a
        (n/4 x 2 x 2) mesh. Every loss must be finite; rank 0 prints them.
        The backend is the caller's: "nccl" (one GPU a rank) or "gloo"
        (the CPU).

    python -m dl_swin_gan_tpu_torch.entry --dryrun N --backend nccl|gloo
"""

import argparse
import math

import numpy as np
import torch


def _tiny_cfg(unrolls=2, features=8, complex_layers=True):
    from dl_swin_gan_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_TYPE = "RES"
    cfg.MODEL.META_ARCHITECTURE = "dlespirit"
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS = unrolls
    p.NUM_RESBLOCKS = 1
    p.NUM_FEATURES = features
    p.CONV_BLOCK.COMPLEX = complex_layers
    cfg.MODEL.RECON_LOSS.RENORMALIZE_DATA = False
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (3, 4)
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.0
    return cfg


def _batch(cfg, B, T=6, Y=16, X=16, C=4, E=2, lr_decom=False):
    """A host batch of B preprocessed synthetic slices."""
    from dl_swin_gan_tpu_torch.data.preprocess import CinePreprocess
    from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example

    pre = CinePreprocess(cfg, use_seed=True, lr_decom=lr_decom)
    examples = [pre(*make_cine_example(T=T, Y=Y, X=X, C=C, E=E, seed=b),
                    f"entry_{b}") for b in range(B)]
    return {k: np.stack([ex[k] for ex in examples]) for k in examples[0]}


def entry(device=None):
    """(fn, args): the example config's forward step on `device` (the GPU
    when none is given), seeded torch-default weights, one synthetic
    8x48x32 slice with 8 coils and 2 maps."""
    from dl_swin_gan_tpu_torch.solvers import build_solver
    from dl_swin_gan_tpu_torch.utils.device import (
        resolve_device, use_ieee_fp32,
    )

    device = resolve_device(device)
    if device.type == "cuda":
        use_ieee_fp32()
    cfg = _tiny_cfg(unrolls=5, features=64)
    cfg.MODEL.PARAMETERS.NUM_RESBLOCKS = 2
    model = build_solver(cfg, generator=torch.Generator().manual_seed(0))
    model.to(device).eval()
    b = _batch(cfg, 1, T=8, Y=48, X=32, C=8)
    args = tuple(torch.from_numpy(b[k]).to(device)
                 for k in ("kspace", "maps", "mask", "init_image"))

    @torch.inference_mode()
    def fn(kspace, maps, mask, init_image):
        return model(kspace, maps, mask, x0=init_image)

    return fn, args


def _step(trainer, batch, key):
    state = trainer.init_state(seed=0)
    metrics = trainer.train_step(state, batch)
    loss = float(metrics[key])
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite {key} in the multi-rank dry run")
    return loss, state


def dryrun_rank(rank, device, n):
    """One rank of the dry run on n ranks (the module docstring): the
    trainers' losses by name; rank 0 prints them."""
    from dl_swin_gan_tpu_torch.parallel.mesh import axis_size, make_mesh
    from dl_swin_gan_tpu_torch.train import (
        DiffusionTrainer, DSLRTrainer, GANTrainer, Trainer,
    )

    fsdp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(data=n // fsdp, fsdp=fsdp)
    shape = f"{n // fsdp}x{fsdp}"
    out = {}

    cfg = _tiny_cfg(features=16)
    batch = _batch(cfg, n)
    out["unrolled"], _ = _step(Trainer(cfg, device=device, mesh=mesh), batch,
                               "Train/complex_l1")

    def dit_cfg():
        dcfg = _tiny_cfg()
        dcfg.MODEL.MODEL_TYPE = "DIT"
        dcfg.MODEL.META_ARCHITECTURE = "DDPM_X"
        p = dcfg.MODEL.PARAMETERS
        p.NUM_UNROLLS, p.NUM_LAYERS, p.NUM_RESBLOCKS = 1, 1, 0
        p.NUM_FEATURES, p.NUM_HEADS = 24, 2
        p.CONV_BLOCK.DTYPE = "bfloat16"
        return dcfg

    out["diffusion"], _ = _step(
        DiffusionTrainer(dit_cfg(), device=device, mesh=mesh,
                         sample_steps=2), batch, "Train MSE")

    gcfg = _tiny_cfg(unrolls=1)
    gcfg.MODEL.GAN.DISC_FEATURES = 8
    gcfg.MODEL.GAN.DISC_LAYERS = 2
    out["gan"], _ = _step(GANTrainer(gcfg, device=device, mesh=mesh), batch,
                          "Train/adv_loss")

    lcfg = _tiny_cfg(unrolls=1)
    lcfg.MODEL.META_ARCHITECTURE = "dslr-cg-v1"
    d = lcfg.MODEL.PARAMETERS.DSLR
    d.NUM_BASIS, d.BLOCK_SIZE, d.NUM_CG_STEPS = 2, 8, 2
    out["dslr"], _ = _step(DSLRTrainer(lcfg, device=device, mesh=mesh),
                           _batch(lcfg, n, lr_decom=True),
                           "Train/complex_l1")

    if n % 4 == 0:
        tp_mesh = make_mesh(data=n // 4, fsdp=2, model=2)
        trainer = DiffusionTrainer(dit_cfg(), device=device, mesh=tp_mesh,
                                   sample_steps=2)
        tbatch = {k: v[:n // 2] for k, v in batch.items()}
        out["tensor-parallel diffusion"], state = _step(trainer, tbatch,
                                                        "Train MSE")
        if not state.model.tp_modules or axis_size(tp_mesh, "model") != 2:
            raise RuntimeError("the tensor-parallel plan matched nothing")
    if rank == 0:
        for name, loss in out.items():
            mesh_text = (f"{n // 4}x2x2 data/fsdp/model"
                         if name.startswith("tensor") else shape)
            print(f"dryrun_multichip OK ({name}): mesh=({mesh_text}) "
                  f"loss={loss:.4f}", flush=True)
    return out


def dryrun_multichip(n: int, backend: str) -> dict:
    """One train step of each trainer on n ranks (see the module
    docstring); returns rank 0's finite losses by trainer."""
    from dl_swin_gan_tpu_torch.parallel.launch import run_ranks

    return run_ranks(dryrun_rank, n, backend, n,
                     threads=1 if backend == "gloo" else None)[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dryrun", type=int, required=True, metavar="N")
    parser.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    args = parser.parse_args(argv)
    dryrun_multichip(args.dryrun, args.backend)


if __name__ == "__main__":
    main()

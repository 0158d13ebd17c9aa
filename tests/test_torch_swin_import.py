"""The port's 2D -> 3D Swin weight import against the JAX package's
(`models/swin_import.py`), on a small 2D checkpoint of the official
microsoft/Swin key schema that the test writes itself: the inflation, the
import into a trunk (compared through `convert.flax_to_torch`), the
shape-mismatch skip, and the Trainer's MODEL.PARAMETERS.PRETRAINED hook
against the JAX Trainer's, which leaves a state_dict the caller gives as it
is."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dl_swin_gan_tpu.config import get_cfg as jax_get_cfg
from dl_swin_gan_tpu.data.preprocess import CinePreprocess as JaxPreprocess
from dl_swin_gan_tpu.models import swin_import as JI
from dl_swin_gan_tpu.models.swin import SwinTransformer3D as JaxTrunk
from dl_swin_gan_tpu.train.trainer import Trainer as JaxTrainer
from dl_swin_gan_tpu_torch.config import get_cfg
from dl_swin_gan_tpu_torch.convert import flax_to_torch
from dl_swin_gan_tpu_torch.data.synthetic import make_cine_example
from dl_swin_gan_tpu_torch.models import swin_import as I
from dl_swin_gan_tpu_torch.models.swin import SwinTransformer3D
from dl_swin_gan_tpu_torch.train import Trainer

torch.set_num_threads(1)

PREFIX = "nets.0.trunks.0."


def _fab_sd2d(rng, embed=16, depths=(2, 2), heads=(2, 4), win2d=7, cin=8,
              patch2d=4):
    """A 2D Swin state_dict with the official key names, the buffers the
    inflation drops included."""
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"patch_embed.proj.weight": f(embed, cin, patch2d, patch2d),
          "patch_embed.proj.bias": f(embed)}
    for i, depth in enumerate(depths):
        dim = embed * 2 ** i
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}"
            sd.update({
                f"{p}.norm1.weight": f(dim), f"{p}.norm1.bias": f(dim),
                f"{p}.attn.qkv.weight": f(3 * dim, dim),
                f"{p}.attn.qkv.bias": f(3 * dim),
                f"{p}.attn.relative_position_bias_table":
                    f((2 * win2d - 1) ** 2, heads[i]),
                f"{p}.attn.relative_position_index": np.zeros(
                    (win2d * win2d, win2d * win2d), np.int64),
                f"{p}.attn_mask": np.zeros((1,), np.float32),
                f"{p}.attn.proj.weight": f(dim, dim),
                f"{p}.attn.proj.bias": f(dim),
                f"{p}.norm2.weight": f(dim), f"{p}.norm2.bias": f(dim),
                f"{p}.mlp.fc1.weight": f(4 * dim, dim),
                f"{p}.mlp.fc1.bias": f(4 * dim),
                f"{p}.mlp.fc2.weight": f(dim, 4 * dim),
                f"{p}.mlp.fc2.bias": f(dim)})
        if i < len(depths) - 1:
            d = f"layers.{i}.downsample"
            sd.update({f"{d}.norm.weight": f(4 * dim),
                       f"{d}.norm.bias": f(4 * dim),
                       f"{d}.reduction.weight": f(2 * dim, 4 * dim)})
    return sd


def _save(sd, path):
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(path))
    return str(path)


def _trunk_state(params):
    """A flax SwinTransformer3D tree as the port trunk's state_dict,
    through flax_to_torch."""
    state = flax_to_torch({"SwinNet3D_0": {"SwinTransformer3D_0": params}})
    return {k[len(PREFIX):]: v for k, v in state.items()}


def _pair(in_chans, embed, patch, depths, heads, window):
    """The JAX trunk's init params (numpy) and a port trunk holding the
    same weights."""
    net = JaxTrunk(in_chans=in_chans, embed_dim=embed, patch_size=patch,
                   depths=depths, num_heads=heads, window_size=window,
                   drop_path_rate=0.0)
    x = jnp.zeros((1, 4, 16, 16, in_chans), jnp.float32)
    params = jax.jit(net.init)(jax.random.PRNGKey(0), x)["params"]
    params = jax.tree.map(np.array, params)
    trunk = SwinTransformer3D(in_chans, embed, patch, depths, heads, window,
                              drop_path_rate=0.0)
    trunk.load_state_dict(_trunk_state(params))
    return params, trunk


def _assert_same(trunk, params):
    ref = _trunk_state(params)
    ours = trunk.state_dict()
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy(),
                                      err_msg=k)


def test_inflate_and_import_match_jax(tmp_path):
    """The inflated dict equals the JAX package's key for key (the bicubic
    13x13 -> 7x7 bias-table resize and the temporal tile included); the
    import writes the same trunk and the same report."""
    rng = np.random.default_rng(0)
    patch, window = (2, 4, 4), (2, 4, 4)
    sd2d = _fab_sd2d(rng)
    path = _save(sd2d, tmp_path / "swin2d.pth")

    ours = I.inflate_swin2d(sd2d, window, patch[0])
    theirs = JI.inflate_swin2d(sd2d, window, patch[0])
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    tab = ours["layers.0.blocks.0.attn.relative_position_bias_table"]
    assert tab.shape == ((2 * window[0] - 1) * 49, 2)

    params, trunk = _pair(8, 16, patch, (2, 2), (2, 4), window)
    report = I.import_swin2d_checkpoint(trunk, path, window_size=window,
                                        patch_t=patch[0])
    jreport = JI.import_swin2d_checkpoint(params, path, window_size=window,
                                          patch_t=patch[0])
    assert report == jreport
    assert not report["skipped"] and not report["missing"]
    n_buffers = sum("relative_position_index" in k or "attn_mask" in k
                    for k in sd2d)
    assert len(report["loaded"]) == len(sd2d) - n_buffers
    _assert_same(trunk, params)
    np.testing.assert_array_equal(
        trunk.layers[0].blocks[1].attn.qkv.weight.detach().numpy(),
        sd2d["layers.0.blocks.1.attn.qkv.weight"])


def test_shape_mismatch_skipped_as_in_jax(tmp_path):
    """A tensor of another shape keeps the trunk's value and is reported
    as skipped; everything else lands, as in the JAX package."""
    rng = np.random.default_rng(1)
    sd = _fab_sd2d(rng, depths=(2,), heads=(2,))
    sd["layers.0.blocks.0.attn.qkv.weight"] = (
        rng.standard_normal((12, 12)).astype(np.float32))
    path = _save(sd, tmp_path / "bad.pth")
    params, trunk = _pair(8, 16, (2, 4, 4), (2,), (2,), (2, 4, 4))
    before = trunk.layers[0].blocks[0].attn.qkv.weight.detach().clone()

    report = I.import_swin2d_checkpoint(trunk, path, window_size=(2, 4, 4),
                                        patch_t=2)
    jreport = JI.import_swin2d_checkpoint(params, path, window_size=(2, 4, 4),
                                          patch_t=2)
    assert report["skipped"] == jreport["skipped"] == [
        "layers.0.blocks.0.attn.qkv.weight"]
    assert report["loaded"] == jreport["loaded"] and report["loaded"]
    assert torch.equal(trunk.layers[0].blocks[0].attn.qkv.weight, before)
    _assert_same(trunk, params)


def _swin_cfg(get, path):
    cfg = get()
    cfg.MODEL.MODEL_TYPE = "SWIN"
    p = cfg.MODEL.PARAMETERS
    p.NUM_UNROLLS = 2
    p.NUM_SWINBLOCKS = 1
    p.NUM_RESBLOCKS = 1
    p.NUM_FEATURES = 8
    p.CONV_BLOCK.COMPLEX = False
    p.PRETRAINED = path
    p.PRETRAINED_STAGE = 1
    cfg.AUG_TRAIN.UNDERSAMPLE.ACCELERATIONS = (4, 5)
    cfg.AUG_TRAIN.UNDERSAMPLE.PARTIAL_KY = 0.0
    cfg.DATALOADER.NUM_WORKERS = 1
    return cfg


def test_trainer_pretrained_hook_matches_jax(tmp_path):
    """MODEL.PARAMETERS.PRETRAINED seeds every unroll's Swin trunk at
    init_state from checkpoint stage PRETRAINED_STAGE (window (7, 8, 8)).
    The checkpoint's stage 1 has the trunk's width; its 4-wide patch embed
    does not fit and keeps the init. Every imported tensor equals the JAX
    Trainer's, through flax_to_torch."""
    rng = np.random.default_rng(3)
    sd = _fab_sd2d(rng, embed=4, depths=(2, 6), heads=(2, 8), win2d=8,
                   cin=8)
    path = _save(sd, tmp_path / "swin2d.pth")
    cfg = _swin_cfg(get_cfg, path)
    cfg.OUTPUT_DIR = str(tmp_path / "torch")
    jcfg = _swin_cfg(jax_get_cfg, path)
    jcfg.OUTPUT_DIR = str(tmp_path / "jax")

    state = Trainer(cfg, device="cpu").init_state()
    ex = JaxPreprocess(jcfg, use_seed=True)(
        *make_cine_example(T=8, Y=32, X=24, C=4, E=2, seed=0), "imp_0")
    jstate = JaxTrainer(jcfg).init_state(
        {k: np.asarray(v)[None] for k, v in ex.items()})
    ref = flax_to_torch(jax.tree.map(np.asarray,
                                     jax.device_get(jstate.params)))
    ours = state.model.state_dict()

    imported = [k for k in ref if ".trunks." in k
                and not k.split(".trunks.0.")[1].startswith("patch_")]
    assert len(imported) == 2 * 6 * 13       # 2 unrolls x 6 blocks x 13
    for k in imported:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy(),
                                      err_msg=k)
    for i in range(2):
        np.testing.assert_array_equal(
            ours[f"nets.{i}.trunks.0.layers.0.blocks.3.attn.qkv.weight"],
            sd["layers.1.blocks.3.attn.qkv.weight"])
    trunk = state.model.nets[0].trunks[0]
    assert trunk.patch_embed.weight.shape == (8, 8, 4, 4, 4)
    assert not np.allclose(trunk.patch_embed.bias.detach().numpy()[:4],
                           sd["patch_embed.proj.bias"])


def test_trainer_pretrained_keeps_given_state_dict(tmp_path):
    """init_state(state_dict=...) loads those weights as they are: with
    PRETRAINED set, the checkpoint does not overwrite them."""
    rng = np.random.default_rng(4)
    sd = _fab_sd2d(rng, embed=4, depths=(2, 6), heads=(2, 8), win2d=8,
                   cin=8)
    cfg = _swin_cfg(get_cfg, _save(sd, tmp_path / "swin2d.pth"))
    cfg.OUTPUT_DIR = str(tmp_path / "torch")
    trainer = Trainer(cfg, device="cpu")
    given = trainer.build_model(torch.Generator().manual_seed(11)).state_dict()
    ours = trainer.init_state(state_dict=given).model.state_dict()
    assert ours.keys() == given.keys()
    for k in given:
        torch.testing.assert_close(ours[k], given[k], rtol=0, atol=0,
                                   msg=k)
    imported = trainer.init_state().model.state_dict()
    k = "nets.0.trunks.0.layers.0.blocks.3.attn.qkv.weight"
    np.testing.assert_array_equal(imported[k],
                                  sd["layers.1.blocks.3.attn.qkv.weight"])
    assert not torch.equal(ours[k], imported[k])

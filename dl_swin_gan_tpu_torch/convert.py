"""Weights for the torch solvers: converted from the JAX package's param
tree, or drawn from a seeded torch-default init.

The JAX tree of a RES/pgd `UnrolledSolver` (nested dicts of arrays):

    ResNet3D_{i}/ConvBlock_0/Conv_0/Conv_0/{kernel [kt,ky,kx,2E,F], bias [F]}
    ResNet3D_{i}/GatedResBlock_{j}/ConvBlock_{0,1}/Conv_0/Conv_0/{kernel, bias}
    ResNet3D_{i}/ConvBlock_1/Conv_0/Conv_0/{kernel [kt,ky,kx,F,2E], bias}
    step_size [1]

maps to `nets.{i}.head`, `nets.{i}.blocks.{j}.conv{0,1}`, `nets.{i}.tail`
and `step_size`. Kernels go from flax's [*k, Cin, Cout] to torch's
[Cout, Cin, *k]; the input channel order [re_0..re_{E-1}, im_0..im_{E-1}] is
the same on both sides. With complex convs (CONV_BLOCK.COMPLEX) a ConvBlock
holds `ComplexConv_0/{kernel_re, kernel_im, bias_re, bias_im}` instead,
which map to `.conv.kernel_re` etc., the kernels transposed the same way.
A separable ConvBlock (CONV_BLOCK.SEPARABLE) holds `SeparableConv_0` with
its spatial conv `{Conv,ComplexConv}_0` and temporal conv `_1`, which map to
`.conv.spatial` and `.conv.temporal`.

SE and CBAM trunks (`SEResNet3D_{i}`, `CBAMResNet3D_{i}`) are the RES tree
plus, in each res block,

    ChannelGate_0/Dense_{0,1}/{kernel, bias}   -> .channel_gate.fc{1,2}
    SpatialGate_0/Conv_0/Conv_0 (or ComplexConv_0) -> .spatial_gate.conv

and the hqs (MoDL) solver carries the scalar `lamda` [1] in place of
`step_size`. `disc_flax_to_torch` converts a PatchGAN discriminator's tree
(`Conv_{k}` -> `convs.{k}`).

The tree of a DSLR `UnrolledLR`:

    ResNet2D_{i}/...        -> spatial.{i}...     (the 2D basis nets)
    ResNet1D_{i}/...        -> temporal.{i}...    (the 1D basis nets)
    RNN_{i}/...             -> temporal.{i}...    (use_rnn_temporal)
    lambda_l, lambda_r [1]  -> lambda_l, lambda_r (the modslr modes)

An RNN (`models/rnn.py`, bidirectional) holds per layer l the forward cell
`LSTMCell_{2l}` and the backward cell `LSTMCell_{2l+1}`, each with input
kernels `ii, if, ig, io` [in, H] (no bias) and recurrent Denses `hi, hf,
hg, ho` {kernel [H, H], bias [H]}, then `Dense_0`. They map to torch's
`lstm.weight_ih_l{l}[_reverse]` (the four kernels transposed and stacked
in the gate order i, f, g, o), `weight_hh_l{l}[_reverse]`, `bias_hh_l{l}`
(the recurrent biases) and a zero `bias_ih_l{l}`, and `dense`.

The tree of a SWIN solver, with S swinblocks:

    SwinNet3D_{i}/SFE                         -> nets.{i}.sfe
    SwinNet3D_{i}/ConvBlock_{k}, k < S        -> nets.{i}.convs.{k}
    SwinNet3D_{i}/ConvBlock_{S}               -> nets.{i}.dfe_conv
    SwinNet3D_{i}/ConvBlock_{S+1}             -> nets.{i}.out_conv
    SwinNet3D_{i}/SwinTransformer3D_{k}/...   -> nets.{i}.trunks.{k}...
        patch_embed {kernel [4,4,4,Cin,F], bias}      Conv3d weight [F,Cin,4,4,4]
        patch_unembed {kernel [4,4,4,F,Cin], bias}    ConvTranspose3d weight
            [F, Cin, 4,4,4], the kernel flipped: flax's ConvTranspose does not
            flip it (transpose_kernel=False) and torch's conv_transpose3d does
        BasicLayer_{l}/SwinBlock3D_{j}/LayerNorm_0, LayerNorm_1  -> norm1, norm2
        BasicLayer_{l}/SwinBlock3D_{j}/attn/{relative_position_bias_table,
            qkv, proj}                                 -> attn.*
        BasicLayer_{l}/SwinBlock3D_{j}/Mlp_0/Dense_{0,1}   -> mlp.fc{1,2}
        BasicLayer_{l}/PatchMerging_0/{LayerNorm_0, Dense_0}
            -> layers.{l}.downsample.{norm, reduction}
        PatchExpand_{j}/{Dense_0, LayerNorm_0}  -> expands.{j}.{expand, norm}

The tree of a diffusion solver (`DiffusionUnrolled`) holds one net per
unroll (one with SHARE_WEIGHTS), plus the final unroll's 2x-channel net
under LEARN_SIGMA; its flax names need not be consecutive (non-shared
LEARN_SIGMA skips the replaced net's index), so the k-th in index order
becomes `nets.{k}`:

    DiTResNet_{i}/SFE, final_layer, var_layer (ConvBlocks) -> nets.{k}.sfe,
        .final_layer, .var_layer
    DiTResNet_{i}/DiT/x_embedder {kernel [p0,p1,p2,Cin,D], bias}
        -> nets.{k}.dit.x_embedder (Conv3d)
    .../t_embedder/Dense_{0,1}         -> .t_embedder.fc{1,2}
    .../y_embedder/Embed_0/embedding   -> .y_embedder.embedding_table.weight
    .../DiTBlockFactor_{j} or DiTBlock_{j} (Latte: TransformerBlock_{j})
        /adaLN_modulation, attn/{qkv, proj}, Mlp_0/Dense_{0,1}
        -> .blocks.{j}.adaLN_modulation, .attn.{qkv, proj}, .mlp.fc{1,2}
    .../final_layer/{adaLN_modulation, linear} -> .final_layer.*
    LatteNet_{i}/Latte/...   -> nets.{k}.latte... (x_embedder a Conv2d)
    SwinDiffNet_{i}/SFE, ConvBlock_{j}, final_layer -> .sfe, .convs.{j},
        .final_layer; t_embedder, y_embedder as above;
        film_in_{j}, film_out_{j} (Dense) -> .film_in.{j}, .film_out.{j};
        SwinTransformer3D_{j} -> .trunks.{j}, as in the Swin tree

Dense kernels [in, out] become Linear weights [out, in]; a LayerNorm's
`scale` becomes its `weight`; the bias table is copied as it is. A key with
no counterpart raises KeyError.

`torch_to_flax` inverts `flax_to_torch` for the RES, SE and CBAM solvers
and the DSLR solver (ResNet or RNN temporal nets), so the JAX package can
serve the port's trained weights.
"""

from typing import Dict, Mapping

import numpy as np
import torch

from dl_swin_gan_tpu_torch.solvers import build_model


def _kernel(kernel) -> torch.Tensor:
    """flax [*k, Cin, Cout] -> torch [Cout, Cin, *k]."""
    kernel = np.asarray(kernel, dtype=np.float32)
    nd = kernel.ndim - 2
    return _array(kernel.transpose(nd + 1, nd, *range(nd)))


def _conv_module(name: str, node: Mapping, prefix: str):
    """One flax conv module -> the torch conv at `prefix`: `Conv_k` (real,
    its leaves under a nested `Conv_0`) or `ComplexConv_k`."""
    if name.startswith("ComplexConv_"):
        leaf = _leaf(node, prefix,
                     ("kernel_re", "kernel_im", "bias_re", "bias_im"))
        return {f"{prefix}.{k}": (_kernel(v) if k.startswith("kernel")
                                  else _array(v))
                for k, v in leaf.items()}
    if not name.startswith("Conv_"):
        _unknown(prefix, name)
    leaf = _leaf(_leaf(node, prefix, ("Conv_0",))["Conv_0"], prefix,
                 ("kernel", "bias"))
    return {f"{prefix}.weight": _kernel(leaf["kernel"]),
            f"{prefix}.bias": _array(leaf["bias"])}


def _conv(block: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A ConvBlock's conv: real (Conv_0/Conv_0), complex (ComplexConv_0), or
    separable (SeparableConv_0 holding the spatial conv _0 and the temporal
    conv _1 of either kind)."""
    if len(block) != 1:
        raise KeyError(f"{prefix}: expected one conv, got {sorted(block)}")
    (name, node), = block.items()
    if name != "SeparableConv_0":
        return _conv_module(name, node, f"{prefix}.conv")
    out = {}
    for child, sub in node.items():
        part = {0: "spatial", 1: "temporal"}.get(_index(child))
        if part is None:
            _unknown(prefix, child)
        out.update(_conv_module(child, sub, f"{prefix}.conv.{part}"))
    return out


def _res_block(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A GatedResBlock: its two ConvBlocks and the SE/CBAM gates."""
    out = {}
    for name, node in tree.items():
        if name in ("ConvBlock_0", "ConvBlock_1"):
            out.update(_conv(node, f"{prefix}.conv{_index(name)}"))
        elif name == "ChannelGate_0":
            gate = _leaf(node, prefix, ("Dense_0", "Dense_1"))
            out.update(_dense(gate["Dense_0"], f"{prefix}.channel_gate.fc1"))
            out.update(_dense(gate["Dense_1"], f"{prefix}.channel_gate.fc2"))
        elif name == "SpatialGate_0":
            if len(node) != 1:
                raise KeyError(f"{prefix}: spatial gate {sorted(node)}")
            (child, sub), = node.items()
            out.update(_conv_module(child, sub,
                                    f"{prefix}.spatial_gate.conv"))
        else:
            _unknown(prefix, name)
    return out


def _resnet(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for name, node in tree.items():
        if name == "ConvBlock_0":
            out.update(_conv(node, f"{prefix}.head"))
        elif name == "ConvBlock_1":
            out.update(_conv(node, f"{prefix}.tail"))
        elif name.startswith("GatedResBlock_"):
            out.update(_res_block(node, f"{prefix}.blocks.{_index(name)}"))
        else:
            raise KeyError(f"{prefix}: no torch counterpart for {name}")
    return out


def _array(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _leaf(node: Mapping, prefix: str, keys) -> Mapping:
    if set(node) != set(keys):
        raise KeyError(f"{prefix}: expected {sorted(keys)}, got {sorted(node)}")
    return node


def _dense(node: Mapping, prefix: str, bias: bool = True):
    leaf = _leaf(node, prefix, ("kernel", "bias") if bias else ("kernel",))
    out = {f"{prefix}.weight": _array(np.asarray(leaf["kernel"]).T)}
    if bias:
        out[f"{prefix}.bias"] = _array(leaf["bias"])
    return out


def _layer_norm(node: Mapping, prefix: str):
    leaf = _leaf(node, prefix, ("scale", "bias"))
    return {f"{prefix}.weight": _array(leaf["scale"]),
            f"{prefix}.bias": _array(leaf["bias"])}


def _index(name: str) -> int:
    return int(name.rsplit("_", 1)[1])


def _unknown(prefix: str, name: str):
    raise KeyError(f"{prefix}: no torch counterpart for {name}")


def _swin_block(tree: Mapping, prefix: str):
    out = {}
    for name, node in tree.items():
        if name in ("LayerNorm_0", "LayerNorm_1"):
            out.update(_layer_norm(node, f"{prefix}.norm{_index(name) + 1}"))
        elif name == "attn":
            attn = _leaf(node, f"{prefix}.attn",
                         ("relative_position_bias_table", "qkv", "proj"))
            out[f"{prefix}.attn.relative_position_bias_table"] = _array(
                attn["relative_position_bias_table"])
            out.update(_dense(attn["qkv"], f"{prefix}.attn.qkv",
                              bias="bias" in attn["qkv"]))
            out.update(_dense(attn["proj"], f"{prefix}.attn.proj"))
        elif name == "Mlp_0":
            mlp = _leaf(node, f"{prefix}.mlp", ("Dense_0", "Dense_1"))
            out.update(_dense(mlp["Dense_0"], f"{prefix}.mlp.fc1"))
            out.update(_dense(mlp["Dense_1"], f"{prefix}.mlp.fc2"))
        else:
            _unknown(prefix, name)
    return out


def _patch_norm_dense(node: Mapping, prefix: str, dense_name: str):
    leaf = _leaf(node, prefix, ("Dense_0", "LayerNorm_0"))
    return {**_dense(leaf["Dense_0"], f"{prefix}.{dense_name}", bias=False),
            **_layer_norm(leaf["LayerNorm_0"], f"{prefix}.norm")}


def _swin_transformer(tree: Mapping, prefix: str):
    out = {}
    for name, node in tree.items():
        if name in ("patch_embed", "patch_unembed"):
            leaf = _leaf(node, f"{prefix}.{name}", ("kernel", "bias"))
            if name == "patch_embed":    # [k.., Cin, Cout] -> [Cout, Cin, k..]
                kernel = _kernel(leaf["kernel"])
            else:                        # flipped, [k.., in, out] -> [in, out, k..]
                kernel = _array(np.asarray(leaf["kernel"], np.float32)[
                    ::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))
            out[f"{prefix}.{name}.weight"] = kernel
            out[f"{prefix}.{name}.bias"] = _array(leaf["bias"])
        elif name.startswith("BasicLayer_"):
            layer = f"{prefix}.layers.{_index(name)}"
            for child, sub in node.items():
                if child.startswith("SwinBlock3D_"):
                    out.update(_swin_block(
                        sub, f"{layer}.blocks.{_index(child)}"))
                elif child == "PatchMerging_0":
                    out.update(_patch_norm_dense(
                        sub, f"{layer}.downsample", "reduction"))
                else:
                    _unknown(layer, child)
        elif name.startswith("PatchExpand_"):
            out.update(_patch_norm_dense(
                node, f"{prefix}.expands.{_index(name)}", "expand"))
        else:
            _unknown(prefix, name)
    return out


def _swinnet(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    nsb = sum(name.startswith("SwinTransformer3D_") for name in tree)
    out = {}
    for name, node in tree.items():
        if name == "SFE":
            out.update(_conv(node, f"{prefix}.sfe"))
        elif name.startswith("ConvBlock_") and _index(name) <= nsb + 1:
            k = _index(name)
            target = (f"convs.{k}" if k < nsb else
                      "dfe_conv" if k == nsb else "out_conv")
            out.update(_conv(node, f"{prefix}.{target}"))
        elif name.startswith("SwinTransformer3D_"):
            out.update(_swin_transformer(
                node, f"{prefix}.trunks.{_index(name)}"))
        else:
            _unknown(prefix, name)
    return out


def _embedders(name: str, node: Mapping, prefix: str):
    """A diffusion backbone's t_embedder / y_embedder, or None."""
    if name == "t_embedder":
        leaf = _leaf(node, f"{prefix}.t_embedder", ("Dense_0", "Dense_1"))
        return {**_dense(leaf["Dense_0"], f"{prefix}.t_embedder.fc1"),
                **_dense(leaf["Dense_1"], f"{prefix}.t_embedder.fc2")}
    if name == "y_embedder":
        table = _leaf(_leaf(node, f"{prefix}.y_embedder", ("Embed_0",))[
            "Embed_0"], f"{prefix}.y_embedder", ("embedding",))
        return {f"{prefix}.y_embedder.embedding_table.weight":
                _array(table["embedding"])}
    return None


def _adaln_block(tree: Mapping, prefix: str):
    """A DiTBlockFactor / DiTBlock / TransformerBlock."""
    out = {}
    for name, node in tree.items():
        if name == "adaLN_modulation":
            out.update(_dense(node, f"{prefix}.adaLN_modulation"))
        elif name == "attn":
            attn = _leaf(node, f"{prefix}.attn", ("qkv", "proj"))
            out.update(_dense(attn["qkv"], f"{prefix}.attn.qkv"))
            out.update(_dense(attn["proj"], f"{prefix}.attn.proj"))
        elif name == "Mlp_0":
            mlp = _leaf(node, f"{prefix}.mlp", ("Dense_0", "Dense_1"))
            out.update(_dense(mlp["Dense_0"], f"{prefix}.mlp.fc1"))
            out.update(_dense(mlp["Dense_1"], f"{prefix}.mlp.fc2"))
        else:
            _unknown(prefix, name)
    return out


_BLOCKS = ("DiTBlockFactor_", "DiTBlock_", "TransformerBlock_")


def _transformer(tree: Mapping, prefix: str):
    """DiT or Latte: the patch embedding, the embedders, the blocks and the
    final layer."""
    out = {}
    for name, node in tree.items():
        emb = _embedders(name, node, prefix)
        if emb is not None:
            out.update(emb)
        elif name == "x_embedder":
            leaf = _leaf(node, f"{prefix}.x_embedder", ("kernel", "bias"))
            out[f"{prefix}.x_embedder.weight"] = _kernel(leaf["kernel"])
            out[f"{prefix}.x_embedder.bias"] = _array(leaf["bias"])
        elif name.startswith(_BLOCKS):
            out.update(_adaln_block(node, f"{prefix}.blocks.{_index(name)}"))
        elif name == "final_layer":
            leaf = _leaf(node, f"{prefix}.final_layer",
                         ("adaLN_modulation", "linear"))
            out.update(_dense(leaf["adaLN_modulation"],
                              f"{prefix}.final_layer.adaLN_modulation"))
            out.update(_dense(leaf["linear"], f"{prefix}.final_layer.linear"))
        else:
            _unknown(prefix, name)
    return out


def _dit_resnet(tree: Mapping, prefix: str):
    out = {}
    for name, node in tree.items():
        if name in ("SFE", "final_layer", "var_layer"):
            out.update(_conv(node, f"{prefix}.{name.lower()}"))
        elif name == "DiT":
            out.update(_transformer(node, f"{prefix}.dit"))
        else:
            _unknown(prefix, name)
    return out


def _latte_net(tree: Mapping, prefix: str):
    (name, node), = _leaf(tree, prefix, ("Latte",)).items()
    return _transformer(node, f"{prefix}.latte")


def _swin_diff(tree: Mapping, prefix: str):
    out = {}
    for name, node in tree.items():
        emb = _embedders(name, node, prefix)
        if emb is not None:
            out.update(emb)
        elif name in ("SFE", "final_layer"):
            out.update(_conv(node, f"{prefix}.{name.lower()}"))
        elif name.startswith("ConvBlock_"):
            out.update(_conv(node, f"{prefix}.convs.{_index(name)}"))
        elif name.startswith(("film_in_", "film_out_")):
            film = name.rsplit("_", 1)[0]
            out.update(_dense(node, f"{prefix}.{film}.{_index(name)}"))
        elif name.startswith("SwinTransformer3D_"):
            out.update(_swin_transformer(
                node, f"{prefix}.trunks.{_index(name)}"))
        else:
            _unknown(prefix, name)
    return out


_GATES = ("i", "f", "g", "o")      # torch's LSTM gate order


def _rnn(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A bidirectional RNN's flax tree -> the torch RNN at `prefix`."""
    cells = sorted((n for n in tree if n.startswith("LSTMCell_")),
                   key=_index)
    if set(tree) != set(cells) | {"Dense_0"} or len(cells) % 2:
        raise KeyError(f"{prefix}: RNN tree {sorted(tree)}")
    out = _dense(tree["Dense_0"], f"{prefix}.dense")
    for name in cells:
        k = _index(name)
        cell = _leaf(tree[name], f"{prefix}.{name}",
                     [f"i{g}" for g in _GATES] + [f"h{g}" for g in _GATES])
        suffix = f"l{k // 2}" + ("_reverse" if k % 2 else "")
        lstm = f"{prefix}.lstm"
        out[f"{lstm}.weight_ih_{suffix}"] = _array(np.concatenate(
            [np.asarray(_leaf(cell[f"i{g}"], lstm, ("kernel",))["kernel"]).T
             for g in _GATES]))
        hs = [_leaf(cell[f"h{g}"], lstm, ("kernel", "bias")) for g in _GATES]
        out[f"{lstm}.weight_hh_{suffix}"] = _array(np.concatenate(
            [np.asarray(h["kernel"]).T for h in hs]))
        out[f"{lstm}.bias_hh_{suffix}"] = _array(np.concatenate(
            [np.asarray(h["bias"]) for h in hs]))
        out[f"{lstm}.bias_ih_{suffix}"] = torch.zeros_like(
            out[f"{lstm}.bias_hh_{suffix}"])
    return out


# flax submodule name prefix -> (converter, torch module list)
_DENOISERS = {"ResNet3D_": (_resnet, "nets"), "SEResNet3D_": (_resnet, "nets"),
              "CBAMResNet3D_": (_resnet, "nets"),
              "SwinNet3D_": (_swinnet, "nets"),
              "ResNet2D_": (_resnet, "spatial"),
              "ResNet1D_": (_resnet, "temporal"),
              "RNN_": (_rnn, "temporal")}
# the diffusion solver's nets: numbered by their rank in index order
_DIFFUSION = {"DiTResNet_": _dit_resnet, "LatteNet_": _latte_net,
              "SwinDiffNet_": _swin_diff}
_SCALARS = ("step_size", "lamda", "lambda_l", "lambda_r")


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX solver params (an `UnrolledSolver` with a RES, SE, CBAM or SWIN
    denoiser, a `DiffusionUnrolled` with a DiT, Latte or SwinDiff backbone,
    or a DSLR `UnrolledLR`) -> torch state_dict."""
    state = {}
    diffusion = sorted((n for n in params if n.startswith(tuple(_DIFFUSION))),
                       key=_index)
    for name, node in params.items():
        if name in _SCALARS:
            state[name] = _array(np.asarray(node).reshape(1))
            continue
        if name in diffusion:
            convert = next(v for key, v in _DIFFUSION.items()
                           if name.startswith(key))
            state.update(convert(node, f"nets.{diffusion.index(name)}"))
            continue
        match = next((v for key, v in _DENOISERS.items()
                      if name.startswith(key)), None)
        if match is None:
            raise KeyError(f"no torch counterpart for param {name}")
        convert, modules = match
        state.update(convert(node, f"{modules}.{_index(name)}"))
    return state


# ------------------------------------------------------------ torch -> flax

# MODEL_TYPE -> the flax name prefix of its unrolled nets
_RESNET_ROOTS = {"RES": "ResNet3D_", "SE": "SEResNet3D_",
                 "CBAM": "CBAMResNet3D_"}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _flax_kernel(weight: torch.Tensor) -> np.ndarray:
    """torch [Cout, Cin, *k] -> flax [*k, Cin, Cout]."""
    w = _np(weight)
    nd = w.ndim - 2
    return w.transpose(*range(2, nd + 2), 1, 0)


def _flax_conv(state: Mapping, prefix: str, index: int = 0) -> dict:
    """The torch conv at `prefix` -> {name: node} of its flax conv module:
    `Conv_{index}` (leaves under a nested `Conv_0`) or
    `ComplexConv_{index}`."""
    if f"{prefix}.kernel_re" in state:
        return {f"ComplexConv_{index}": {
            k: (_flax_kernel(state[f"{prefix}.{k}"]) if k.startswith("kernel")
                else _np(state[f"{prefix}.{k}"]))
            for k in ("kernel_re", "kernel_im", "bias_re", "bias_im")}}
    return {f"Conv_{index}": {"Conv_0": {
        "kernel": _flax_kernel(state[f"{prefix}.weight"]),
        "bias": _np(state[f"{prefix}.bias"])}}}


def _flax_conv_block(state: Mapping, prefix: str) -> dict:
    """A ConvBlock at `prefix` (its conv at `prefix.conv`): full or
    separable."""
    conv = f"{prefix}.conv"
    if any(k.startswith(f"{conv}.spatial.") for k in state):
        return {"SeparableConv_0": {
            **_flax_conv(state, f"{conv}.spatial", 0),
            **_flax_conv(state, f"{conv}.temporal", 1)}}
    return _flax_conv(state, conv)


def _flax_dense(state: Mapping, prefix: str) -> dict:
    return {"kernel": _np(state[f"{prefix}.weight"]).T.copy(),
            "bias": _np(state[f"{prefix}.bias"])}


def _flax_resnet(state: Mapping, p: str, consumed) -> dict:
    """The torch ResNet at `p` -> its flax tree (ConvBlock_0 / _1 and the
    GatedResBlocks with their gates)."""
    net = {"ConvBlock_0": _flax_conv_block(state, f"{p}.head"),
           "ConvBlock_1": _flax_conv_block(state, f"{p}.tail")}
    consumed(f"{p}.head")
    consumed(f"{p}.tail")
    blocks = sorted({int(k[len(p):].split(".")[2]) for k in state
                     if k.startswith(f"{p}.blocks.")})
    for j in blocks:
        b = f"{p}.blocks.{j}"
        block = {f"ConvBlock_{c}": _flax_conv_block(state, f"{b}.conv{c}")
                 for c in (0, 1)}
        consumed(f"{b}.conv0")
        consumed(f"{b}.conv1")
        if f"{b}.channel_gate.fc1.weight" in state:
            block["ChannelGate_0"] = {
                "Dense_0": _flax_dense(state, f"{b}.channel_gate.fc1"),
                "Dense_1": _flax_dense(state, f"{b}.channel_gate.fc2")}
            consumed(f"{b}.channel_gate")
        if any(k.startswith(f"{b}.spatial_gate.") for k in state):
            block["SpatialGate_0"] = _flax_conv(
                state, f"{b}.spatial_gate.conv")
            consumed(f"{b}.spatial_gate")
        net[f"GatedResBlock_{j}"] = block
    return net


def _flax_rnn(state: Mapping, p: str, used: set) -> dict:
    """The torch RNN at `p` -> its flax tree (the inverse of `_rnn`; an
    input-side bias is added to the recurrent one, which is exact for the
    zero bias_ih the port draws and converts); the keys read go to
    `used`."""
    tree = {"Dense_0": _flax_dense(state, f"{p}.dense")}
    used.update((f"{p}.dense.weight", f"{p}.dense.bias"))
    lstm = f"{p}.lstm"
    head = f"{lstm}.weight_ih_l"
    layers = sorted({int(k[len(head):].split("_")[0]) for k in state
                     if k.startswith(head)})
    for layer in layers:
        for rev, suffix in enumerate((f"l{layer}", f"l{layer}_reverse")):
            keys = [f"{lstm}.{w}_{suffix}" for w in
                    ("weight_ih", "weight_hh", "bias_hh", "bias_ih")]
            w_ih, w_hh, b_hh, b_ih = (_np(state[k]) for k in keys)
            used.update(keys)
            H = w_hh.shape[1]
            cell = {}
            for g, gate in enumerate(_GATES):
                rows = slice(g * H, (g + 1) * H)
                cell[f"i{gate}"] = {"kernel": w_ih[rows].T.copy()}
                cell[f"h{gate}"] = {"kernel": w_hh[rows].T.copy(),
                                    "bias": (b_hh + b_ih)[rows].copy()}
            tree[f"LSTMCell_{2 * layer + rev}"] = cell
    return tree


def rnn_torch_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """A torch `RNN`'s state_dict (bidirectional) -> the flax RNN's
    params."""
    wrapped = {f"rnn.{k}": v for k, v in state.items()}
    return _flax_rnn(wrapped, "rnn", set())


def rnn_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax RNN's params -> a torch `RNN`'s state_dict."""
    return {k[len("rnn."):]: v for k, v in _rnn(params, "rnn").items()}


def torch_to_flax(state: Mapping[str, torch.Tensor],
                  model_type: str) -> dict:
    """The inverse of `flax_to_torch` for an `UnrolledSolver` with a RES,
    SE or CBAM trunk (MODEL_TYPE `model_type`), or for a DSLR `UnrolledLR`
    (its `spatial` and `temporal` nets; model_type is then not read): the
    port's state_dict -> the JAX package's param tree. Every key of
    `state` must be consumed; one with no flax counterpart raises
    KeyError."""
    tree, used = {}, set()
    consumed = lambda prefix: used.update(   # noqa: E731
        k for k in state if k.startswith(prefix + "."))

    def indices(module):
        return sorted({int(k.split(".")[1]) for k in state
                       if k.startswith(module + ".")})

    if any(k.startswith("spatial.") for k in state):
        for i in indices("spatial"):
            tree[f"ResNet2D_{i}"] = _flax_resnet(state, f"spatial.{i}",
                                                 consumed)
        for i in indices("temporal"):
            p = f"temporal.{i}"
            if f"{p}.dense.weight" in state:
                tree[f"RNN_{i}"] = _flax_rnn(state, p, used)
            else:
                tree[f"ResNet1D_{i}"] = _flax_resnet(state, p, consumed)
    else:
        root = _RESNET_ROOTS[model_type.upper()]
        for i in indices("nets"):
            tree[f"{root}{i}"] = _flax_resnet(state, f"nets.{i}", consumed)
    for name in _SCALARS:
        if name in state:
            tree[name] = _np(state[name]).reshape(1)
            used.add(name)
    left = sorted(set(state) - used)
    if left:
        raise KeyError(f"no flax counterpart for {left}")
    return tree


def disc_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `PatchDiscriminator3D` params (Conv_0 .. Conv_{L+1}, flax
    nn.Conv leaves) -> the torch discriminator's state_dict."""
    out = {}
    for name, node in params.items():
        if not name.startswith("Conv_"):
            _unknown("discriminator", name)
        leaf = _leaf(node, name, ("kernel", "bias"))
        out[f"convs.{_index(name)}.weight"] = _kernel(leaf["kernel"])
        out[f"convs.{_index(name)}.bias"] = _array(leaf["bias"])
    return out


def init_params(cfg, seed: int) -> Dict[str, torch.Tensor]:
    """A seeded torch-default init of the solver the config describes."""
    return build_model(cfg, torch.Generator().manual_seed(seed)).state_dict()

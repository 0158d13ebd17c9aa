"""Experiment-folder naming convention.

A copy of `utils/folder_param.py` in the JAX package (the reference's
`dl_cs/fileio/folder_param.py:8-75`):
hyperparameters <-> run-folder names of the form
`train-3D_{N}steps_{M}{type}_{F}features_{E}emaps_{W}weight`, parsed back by
the evaluation tooling (batch_recon). The reference only names RES/SE runs;
the SWIN/DIT/LATTE tokens are an extension here, and encode each model's
OWN depth knob (swinblocks / transformer layers) — encoding NUM_RESBLOCKS
for every type would give two Swin runs differing only in depth the same
folder name, so batch_recon would overwrite one with the other.
"""

_MODEL_TO_TOKEN = {"RES": "resblocks", "SE": "SEblocks", "CBAM": "CBAMblocks",
                   "SWIN": "SWINblocks", "DIT": "DiTblocks",
                   "LATTE": "Latteblocks"}
_TOKEN_TO_MODEL = {v: k for k, v in _MODEL_TO_TOKEN.items()}
# which MODEL.PARAMETERS knob the block count in the name refers to
_MODEL_TO_DEPTH_KEY = {"RES": "NUM_RESBLOCKS", "SE": "NUM_RESBLOCKS",
                       "CBAM": "NUM_RESBLOCKS", "SWIN": "NUM_SWINBLOCKS",
                       "DIT": "NUM_LAYERS", "LATTE": "NUM_LAYERS"}


def parameter_to_folder(config) -> str:
    p = config.MODEL.PARAMETERS
    weight = 1 if config.MODEL.RECON_LOSS.LOSS_WEIGHT else 0
    model = config.MODEL.MODEL_TYPE.upper()
    token = _MODEL_TO_TOKEN.get(model, "resblocks")
    depth = p[_MODEL_TO_DEPTH_KEY.get(model, "NUM_RESBLOCKS")]
    return (f"train-3D_{p.NUM_UNROLLS}steps_{depth}{token}_"
            f"{p.NUM_FEATURES}features_{p.NUM_EMAPS}emaps_{weight}weight")


def folder_to_parameter(folder_name: str, write_config: bool = False,
                        config=None) -> dict:
    param = {}
    for part in folder_name.split("_"):
        for token in _TOKEN_TO_MODEL:
            if part.endswith(token):
                param["model_type"] = token
                param["num_blocks"] = int(part[:-len(token)])
                # legacy key, meaningful for the conv backbones
                param["num_resblocks"] = param["num_blocks"]
        if part.endswith("steps"):
            param["num_unrolls"] = int(part[:-5])
        elif part.endswith("features"):
            param["num_features"] = int(part[:-8])
        elif part.endswith("emaps"):
            param["num_emaps"] = int(part[:-5])
        elif part.endswith("weight"):
            param["loss_weight"] = part[:-6] == "1"

    if write_config and config is not None:
        config.MODEL.PARAMETERS.NUM_UNROLLS = param["num_unrolls"]
        config.MODEL.PARAMETERS.NUM_EMAPS = param["num_emaps"]
        config.MODEL.PARAMETERS.NUM_FEATURES = param["num_features"]
        config.MODEL.RECON_LOSS.LOSS_WEIGHT = param["loss_weight"]
        if "model_type" in param:
            model = _TOKEN_TO_MODEL[param["model_type"]]
            config.MODEL.MODEL_TYPE = model
            config.MODEL.PARAMETERS[_MODEL_TO_DEPTH_KEY[model]] = \
                param["num_blocks"]
        else:
            config.MODEL.PARAMETERS.NUM_RESBLOCKS = param["num_resblocks"]
    return param

"""Lightweight yacs-style config system.

Counterpart of `config/config.py` in the JAX package: the same key schema and
merge rules, so every YAML under `configs/` loads unchanged. `yaml` is
imported only inside the functions that parse or emit YAML, so a config built
in code needs no pyyaml.
"""

import ast
import copy
from typing import Any, Dict


def _decode_value(value: Any) -> Any:
    """yacs-style value decoding: strings that parse as Python literals
    (tuples like "(10, 15)", booleans, numbers) become those literals."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


class CfgNode(dict):
    """Dict with attribute access, recursive merge, and freeze support."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init: Dict = None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no key '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE):
            raise AttributeError(f"Config is frozen; cannot set '{name}'")
        self[name] = value

    def __setitem__(self, key, value):
        if self.__dict__.get(CfgNode.IMMUTABLE):
            raise AttributeError(f"Config is frozen; cannot set '{key}'")
        super().__setitem__(key, value)

    # dict bulk mutation must respect freeze too
    def _check_mutable(self):
        if self.__dict__.get(CfgNode.IMMUTABLE):
            raise AttributeError("Config is frozen; cannot mutate")

    def update(self, *args, **kwargs):
        self._check_mutable()
        return super().update(*args, **kwargs)

    def setdefault(self, *args):
        self._check_mutable()
        return super().setdefault(*args)

    def pop(self, *args):
        self._check_mutable()
        return super().pop(*args)

    def popitem(self):
        self._check_mutable()
        return super().popitem()

    def clear(self):
        self._check_mutable()
        return super().clear()

    def __delitem__(self, key):
        self._check_mutable()
        return super().__delitem__(key)

    # -- freeze ------------------------------------------------------------
    def freeze(self) -> None:
        self.__dict__[CfgNode.IMMUTABLE] = True
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        self.__dict__[CfgNode.IMMUTABLE] = False
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    # -- merge ---------------------------------------------------------------
    def merge_from_other(self, other: "CfgNode", allow_new: bool = False) -> None:
        for k, v in other.items():
            if k not in self and not allow_new:
                raise KeyError(f"Non-existent config key: {k}")
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_other(CfgNode(v), allow_new)
            else:
                cur = self.get(k)
                v = _decode_value(v)
                if isinstance(cur, tuple) and isinstance(v, list):
                    v = tuple(v)
                self[k] = v

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        loaded = CfgNode(loaded)
        # a file newer than this schema fails loudly; an older one is walked
        # through the converters before merging
        from dl_swin_gan_tpu_torch.config import compat
        loaded_ver = compat.guess_version(loaded)
        own_ver = int(self.get("VERSION", compat.LATEST_VERSION))
        if loaded_ver > own_ver:
            raise ValueError(f"Cannot merge a v{loaded_ver} config file "
                             f"({path}) into a v{own_ver} config")
        if loaded_ver != own_ver:
            loaded = compat.upgrade_config(loaded, to_version=own_ver)
        self.merge_from_other(loaded)

    def merge_from_list(self, opts) -> None:
        """Merge from a flat ['KEY.SUBKEY', value, ...] list (CLI overrides)."""
        if len(opts) % 2:
            raise ValueError("merge_from_list needs KEY VALUE pairs")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            # a typo'd override fails loudly instead of creating a dead key
            if parts[-1] not in node:
                raise KeyError(f"Non-existent config key: {key}")
            old = node.get(parts[-1])
            value = _decode_value(value)
            if isinstance(value, str) and old is not None and not isinstance(old, str):
                import yaml
                value = yaml.safe_load(value)
            if isinstance(old, tuple) and isinstance(value, list):
                value = tuple(value)
            node[parts[-1]] = value

    def clone(self) -> "CfgNode":
        frozen = self.is_frozen()
        self.defrost()
        c = copy.deepcopy(self)
        if frozen:
            self.freeze()
        return c

    def dump(self) -> str:
        import yaml

        def plain(node):
            return {k: plain(v) if isinstance(v, CfgNode) else
                    (list(v) if isinstance(v, tuple) else v)
                    for k, v in node.items()}
        return yaml.safe_dump(plain(self), sort_keys=False)


def get_cfg() -> CfgNode:
    """A fresh copy of the defaults tree."""
    from dl_swin_gan_tpu_torch.config.defaults import make_defaults
    return make_defaults()


def load_cfg(path: str, require_output_dir: bool = True,
             freeze: bool = True) -> CfgNode:
    """Load YAML over defaults; freeze; require OUTPUT_DIR."""
    cfg = get_cfg()
    cfg.merge_from_file(path)
    if require_output_dir and not cfg.OUTPUT_DIR:
        raise ValueError("load_cfg requires OUTPUT_DIR to be set")
    if freeze:
        cfg.freeze()
    return cfg

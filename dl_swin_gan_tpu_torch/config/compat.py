"""Versioned config compatibility (counterpart of `config/compat.py` in the
JAX package): `upgrade_config`/`downgrade_config` walk converter classes
between schema versions; `guess_version` infers a version for files without
the key. v1 is the base schema, so no converter is registered yet.
"""

from dl_swin_gan_tpu_torch.config.config import CfgNode

# the current schema version (defaults.py VERSION)
LATEST_VERSION = 1


def guess_version(cfg: CfgNode) -> int:
    """Infer the version of a config that lacks an explicit VERSION key."""
    if "VERSION" in cfg and cfg.VERSION is not None:
        return int(cfg.VERSION)
    return 1


def upgrade_config(cfg: CfgNode, to_version: int = LATEST_VERSION) -> CfgNode:
    cfg = cfg.clone()
    version = guess_version(cfg)
    if version > to_version:
        raise ValueError(f"cannot upgrade from v{version} down to v{to_version}")
    for k in range(version, to_version):
        converter = _CONVERTERS.get(k + 1)
        if converter is None:
            raise KeyError(f"no converter to v{k + 1}")
        converter.upgrade(cfg)
        cfg.VERSION = k + 1
    return cfg


def downgrade_config(cfg: CfgNode, to_version: int) -> CfgNode:
    cfg = cfg.clone()
    version = guess_version(cfg)
    if version < to_version:
        raise ValueError(f"cannot downgrade from v{version} up to v{to_version}")
    for k in range(version, to_version, -1):
        converter = _CONVERTERS.get(k)
        if converter is None:
            raise KeyError(f"no converter from v{k}")
        converter.downgrade(cfg)
        cfg.VERSION = k - 1
    return cfg


class _RenameConverter:
    """Base converter: subclasses list (old, new) dotted key renames."""
    RENAMES = []  # [(old_dotted, new_dotted)]

    @classmethod
    def _move(cls, cfg, old, new):
        node = cfg
        parts = old.split(".")
        for p in parts[:-1]:
            node = node[p]
        value = node.pop(parts[-1])
        tgt = cfg
        nparts = new.split(".")
        for p in nparts[:-1]:
            tgt = tgt.setdefault(p, CfgNode())
        tgt[nparts[-1]] = value

    @classmethod
    def upgrade(cls, cfg):
        for old, new in cls.RENAMES:
            cls._move(cfg, old, new)

    @classmethod
    def downgrade(cls, cfg):
        for old, new in cls.RENAMES:
            cls._move(cfg, new, old)


# version -> converter class, registered as the schema evolves
_CONVERTERS = {}

"""String->class registries (a copy of `lanemapping_tpu/registry.py`).

Parity with the reference registry / build_from_cfg layer
(`baseline/utils/registry.py:12-82`,
`baseline/models/registry.py:5-36`): config dicts carry a ``type`` key naming
a registered class; ``build_from_cfg`` instantiates it with the remaining
keys plus ``cfg=<global config>``.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str):
        return self._module_dict.get(key)

    def register_module(self, cls=None, *, name: Optional[str] = None):
        def _register(c):
            key = name or c.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} already registered in {self._name}")
            self._module_dict[key] = c
            return c

        if cls is None:
            return _register
        return _register(cls)

    def __contains__(self, key):
        return key in self._module_dict

    def __repr__(self):
        return f"Registry({self._name}, items={list(self._module_dict)})"


def build_from_cfg(cfg: Dict, registry: Registry, default_args: Optional[Dict] = None):
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = {k: v for k, v in cfg.items() if k != "type"}
    if default_args:
        args.update(default_args)
    obj_type = cfg["type"]
    obj_cls = registry.get(obj_type)
    if obj_cls is None:
        raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    sig = inspect.signature(obj_cls.__init__ if inspect.isclass(obj_cls) else obj_cls)
    accepted = set(sig.parameters)
    if not any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
        args = {k: v for k, v in args.items() if k in accepted}
    return obj_cls(**args)


# Model-layer registries (reference `baseline/models/registry.py:5-12`).
PCENCODER = Registry("pcencoder")
BACKBONE = Registry("backbone")
HEADS = Registry("heads")
NET = Registry("net")
DATASETS = Registry("datasets")


def build_pcencoder(cfg):
    return build_from_cfg(cfg.pcencoder, PCENCODER, default_args=dict(cfg=cfg))


def build_backbone(cfg):
    return build_from_cfg(cfg.backbone, BACKBONE, default_args=dict(cfg=cfg))


def build_heads(cfg):
    return build_from_cfg(cfg.heads, HEADS, default_args=dict(cfg=cfg))


def build_net(cfg):
    return build_from_cfg(cfg.net, NET, default_args=dict(cfg=cfg))


def build_dataset(split_cfg, cfg):
    return build_from_cfg(split_cfg, DATASETS, default_args=dict(cfg=cfg))

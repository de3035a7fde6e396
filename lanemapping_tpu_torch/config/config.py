"""Python-file configuration system (a copy of `lanemapping_tpu/config/config.py`).

The port reads the same ``configs/*.py`` with the same ``_base_``
inheritance.  Keys that only steer the JAX/TPU build are read and ignored
here: ``mesh_shape`` (the device mesh; the port runs on one card) and
``remat`` / ``remat_policy`` (rematerialisation, a training-memory lever
for a later slice).

API-parity reimplementation of the reference's mmcv-style config loader
(`baseline/utils/config.py:56-411`): configs are plain Python
modules whose module-level globals become an attribute-accessible dict, with
``_base_`` multi-inheritance, ``_delete_`` overrides, and dotted-key CLI
merges.  Written from scratch with zero third-party deps (no addict/yapf).
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types
import uuid
from typing import Any, Dict, List

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"
RESERVED = ("__name__", "__doc__", "__package__", "__loader__", "__spec__",
            "__file__", "__builtins__", "__cached__")


class ConfigDict(dict):
    """dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        d = dict(*args, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return ConfigDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(ConfigDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, ConfigDict._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError:
            raise AttributeError(k)

    def get(self, k, default=None):
        return super().get(k, default)

    def copy(self) -> "ConfigDict":
        return ConfigDict({k: _deepcopy(v) for k, v in self.items()})


def _deepcopy(v):
    if isinstance(v, ConfigDict):
        return v.copy()
    if isinstance(v, dict):
        return {k: _deepcopy(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_deepcopy(x) for x in v)
    return v


def _exec_pyfile(path: str) -> Dict[str, Any]:
    """Execute a python config file in an isolated module, harvest globals."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isfile(path):
        raise FileNotFoundError(f"config file not found: {path}")
    mod_name = f"_lanemapping_cfg_{uuid.uuid4().hex}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    try:
        spec.loader.exec_module(module)
        out = {
            k: v
            for k, v in vars(module).items()
            if k not in RESERVED and not isinstance(v, types.ModuleType)
            and not isinstance(v, types.FunctionType) and not k.startswith("__")
        }
    finally:
        del sys.modules[mod_name]
    return out


def merge_dict(base: Dict, override: Dict) -> Dict:
    """Merge ``override`` into ``base`` (reference `config.py:124-148`).

    Nested dicts merge recursively unless the override dict carries
    ``_delete_: True``, in which case it replaces the base subtree.
    """
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            if v.pop(DELETE_KEY, False) if isinstance(v, dict) else False:
                out[k] = {kk: vv for kk, vv in v.items()}
            else:
                out[k] = merge_dict(out[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            out[k] = v
    return out


class Config:
    """Top-level config object: ``Config.fromfile(path)``."""

    def __init__(self, cfg_dict: Dict[str, Any] = None, filename: str = None):
        self._cfg = ConfigDict(cfg_dict or {})
        self._filename = filename

    # -- constructors ------------------------------------------------------
    @staticmethod
    def fromfile(path: str) -> "Config":
        cfg_dict = Config._load_with_bases(path)
        return Config(cfg_dict, filename=path)

    @staticmethod
    def _load_with_bases(path: str) -> Dict[str, Any]:
        raw = _exec_pyfile(path)
        bases = raw.pop(BASE_KEY, None)
        if bases is None:
            return raw
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        cfg_dir = os.path.dirname(os.path.abspath(path))
        for b in bases:
            b_dict = Config._load_with_bases(os.path.join(cfg_dir, b))
            dup = set(merged) & set(b_dict)
            if dup:
                raise KeyError(f"duplicate keys in _base_ configs: {sorted(dup)}")
            merged.update(b_dict)
        return merge_dict(merged, raw)

    @staticmethod
    def fromdict(d: Dict[str, Any]) -> "Config":
        return Config(d)

    # -- accessors ---------------------------------------------------------
    @property
    def filename(self):
        return self._filename

    def __getattr__(self, k):
        if k.startswith("_"):
            raise AttributeError(k)
        return getattr(self._cfg, k)

    def __getitem__(self, k):
        return self._cfg[k]

    def __setattr__(self, k, v):
        if k.startswith("_"):
            object.__setattr__(self, k, v)
        else:
            self._cfg[k] = v

    def __setitem__(self, k, v):
        self._cfg[k] = v

    def __contains__(self, k):
        return k in self._cfg

    def get(self, k, default=None):
        return self._cfg.get(k, default)

    def keys(self):
        return self._cfg.keys()

    def items(self):
        return self._cfg.items()

    def to_dict(self) -> Dict[str, Any]:
        return _plain(self._cfg)

    # -- CLI override bridge (reference `config.py:353-411`) ---------------
    def merge_from_dict(self, options: Dict[str, Any]):
        """Merge dotted-key options, e.g. ``{"optimizer.lr": 1e-4}``.

        Convenience: overriding ``dataset_path`` also rewrites the per-split
        ``dataset.*.data_root`` entries, which the config file derived from
        it at exec time (the reference requires editing the file instead,
        `configs/Proj_polyline_fpn_vit_vertex_2.py:134-139`).
        """
        nested: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = nested
            parts = full_key.split(".")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
        self._cfg = ConfigDict(merge_dict(self.to_dict(), nested))
        if "dataset_path" in options and "dataset" in self._cfg:
            for split in self._cfg["dataset"].values():
                if isinstance(split, dict) and "data_root" in split:
                    split["data_root"] = options["dataset_path"]

    def dump(self, path: str = None) -> str:
        text = _format_dict(self.to_dict())
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def __repr__(self):
        return f"Config(file={self._filename}):\n{_format_dict(self.to_dict())}"


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def _format_dict(d: Dict, indent: int = 0) -> str:
    pad = " " * indent
    lines: List[str] = []
    for k, v in d.items():
        if isinstance(v, dict):
            lines.append(f"{pad}{k} = dict(" if indent == 0 else f"{pad}{k}=dict(")
            lines.append(_format_dict(v, indent + 4))
            lines.append(f"{pad})" + ("" if indent == 0 else ","))
        else:
            sep = " = " if indent == 0 else "="
            tail = "" if indent == 0 else ","
            lines.append(f"{pad}{k}{sep}{v!r}{tail}")
    return "\n".join(lines)


def parse_dict_action(pairs: List[str]) -> Dict[str, Any]:
    """Parse CLI ``key=value`` strings (reference `config.py:382-411`)."""
    import ast

    out = {}
    for pair in pairs:
        k, _, v = pair.partition("=")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out

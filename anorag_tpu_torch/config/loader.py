"""Config loading for the port: YAML over a complete defaults skeleton.

Counterpart of anorag_tpu/config/loader.py, copied with its imports
renamed, except that load_config reads YAML with the port's own reader
(config/yaml_subset.py, no PyYAML, the same on the CPU and the card), and
with the port's Config and as_config added.

Behavioral contract (mirrors the upstream ConfigLoader,
config/config_loader.py:394-646):
  * user YAML deep-merges over DEFAULT_CONFIG — every knob always resolves;
  * unknown keys are collected and reported (not fatal);
  * deprecated keys are reported with their replacement;
  * legacy<->new alias subtrees are synchronized after merge (whichever side
    the user set wins; defaults never overwrite user values);
  * dot-path get/set (`config.get("retrieval.hybrid.weights.dense")`);
  * a process-wide singleton `config` plus independent ConfigLoader instances
    for tests.
"""
from __future__ import annotations

import copy
import os
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

from anorag_tpu_torch.config.defaults import ALIAS_PAIRS, DEPRECATED_KEYS, default_config
from anorag_tpu_torch.config.yaml_subset import safe_load


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Merge `override` into a copy of `base`, recursing into dicts."""
    out = copy.deepcopy(base)
    for key, val in (override or {}).items():
        if key in out and isinstance(out[key], dict) and isinstance(val, dict):
            out[key] = deep_merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


def _walk_unknown(user: Dict[str, Any], skeleton: Dict[str, Any], prefix: str = "") -> List[str]:
    unknown = []
    for key, val in (user or {}).items():
        path = f"{prefix}{key}"
        if key not in skeleton:
            unknown.append(path)
        elif isinstance(val, dict) and isinstance(skeleton.get(key), dict):
            if not skeleton[key]:
                continue  # empty skeleton dict = wildcard section
            unknown.extend(_walk_unknown(val, skeleton[key], prefix=path + "."))
    return unknown


def get_path(cfg: Dict[str, Any], dotted: str, default: Any = None) -> Any:
    node: Any = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def set_path(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for part in parts[:-1]:
        nxt = node.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            node[part] = nxt
        node = nxt
    node[parts[-1]] = value


class ConfigLoader:
    """Loads and owns one merged configuration tree."""

    def __init__(self, config_path: Optional[str] = None, auto_load: bool = True):
        self._lock = threading.RLock()
        self._config: Dict[str, Any] = default_config()
        self._path = config_path
        self.unknown_keys: List[str] = []
        self.deprecated_hits: List[Tuple[str, str]] = []
        if auto_load and config_path and os.path.exists(config_path):
            self.load_config(config_path)

    # ------------------------------------------------------------- loading
    def load_config(self, config_path: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            path = config_path or self._path
            user: Dict[str, Any] = {}
            if path and os.path.exists(path):
                with open(path, "r", encoding="utf-8") as fh:
                    user = safe_load(fh) or {}
                self._path = path
            self.apply_overrides(user)
            return self._config

    def apply_overrides(self, user: Dict[str, Any]) -> None:
        """Merge a dict of user overrides over the current tree."""
        with self._lock:
            skeleton = default_config()
            self.unknown_keys = _walk_unknown(user, skeleton)
            self.deprecated_hits = [
                (k, DEPRECATED_KEYS[k]) for k in DEPRECATED_KEYS if get_path(user, k) is not None
            ]
            self._config = deep_merge(self._config, user)
            self._synchronize_aliases(user)

    def _synchronize_aliases(self, user: Dict[str, Any]) -> None:
        """Keep legacy and new key subtrees equal.

        If the user set exactly one side of an alias pair, the set side is
        copied over the other. If both were set, the *new* (second) side wins.
        """
        for legacy, new in ALIAS_PAIRS:
            legacy_set = get_path(user, legacy) is not None
            new_set = get_path(user, new) is not None
            if new_set or not legacy_set:
                src, dst = new, legacy
            else:
                src, dst = legacy, new
            val = get_path(self._config, src)
            if val is None:
                continue
            dst_val = get_path(self._config, dst)
            if isinstance(val, dict) and isinstance(dst_val, dict):
                set_path(self._config, dst, deep_merge(dst_val, val))
            else:
                set_path(self._config, dst, copy.deepcopy(val))

    # -------------------------------------------------------------- access
    def get(self, dotted: str, default: Any = None) -> Any:
        with self._lock:
            val = get_path(self._config, dotted, default)
            return copy.deepcopy(val) if isinstance(val, (dict, list)) else val

    def set(self, dotted: str, value: Any) -> None:
        with self._lock:
            set_path(self._config, dotted, value)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return copy.deepcopy(self._config)

    def reset(self) -> None:
        with self._lock:
            self._config = default_config()

    # ------------------------------------------------------------ reporting
    def report(self) -> Dict[str, Any]:
        return {
            "path": self._path,
            "unknown_keys": list(self.unknown_keys),
            "deprecated": [{"key": k, "use": v} for k, v in self.deprecated_hits],
        }


class Config(ConfigLoader):
    """One config tree from a dict, as the port's entry points and tests
    build them: None gives the defaults as they stand (ConfigLoader with
    nothing loaded); a dict (a YAML file's tree, or a few keys) is merged
    over the defaults as load_config merges a file, aliases synchronised
    and unknown and deprecated keys reported."""

    def __init__(self, overrides: Optional[Mapping] = None):
        super().__init__(auto_load=False)
        if overrides is not None:
            self.apply_overrides(overrides)

    def __deepcopy__(self, memo):
        out = Config()
        out._config = copy.deepcopy(self._config, memo)
        out._path = self._path
        out.unknown_keys = list(self.unknown_keys)
        out.deprecated_hits = list(self.deprecated_hits)
        return out


def as_config(cfg: Any) -> ConfigLoader:
    """`cfg` when it is a loaded config already, else Config(cfg)."""
    return cfg if isinstance(cfg, ConfigLoader) else Config(cfg)


# Process-wide singleton, like the reference's `config` object
# (upstream config/config_loader.py:646).
config = ConfigLoader(config_path=os.environ.get("ANORAG_CONFIG", "config.yaml"))

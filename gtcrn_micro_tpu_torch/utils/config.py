"""YAML config with ``${a.b}`` interpolation (OmegaConf-style, stdlib-only).

The reference uses OmegaConf YAML with variable interpolation
(conf/cfg_train_DNS3.yaml:28-30, cfg_infer.yaml:12-15) and splats config dicts
into constructors.  OmegaConf isn't in this environment, so this is a minimal
equivalent: dotted access, ``${path.to.key}`` interpolation, and dict/attr
dual access.

PyYAML is imported by the two loaders, not by this module, so that the
package imports on a machine without it.
"""

from __future__ import annotations

import re
from typing import Any

_INTERP = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """Dict with attribute access and dotted-path get."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def select(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def to_dict(self) -> dict:
        def conv(x):
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            if isinstance(x, list):
                return [conv(v) for v in x]
            return x

        return conv(self)


def _wrap(node: Any) -> Any:
    if isinstance(node, dict):
        return Config({k: _wrap(v) for k, v in node.items()})
    if isinstance(node, list):
        return [_wrap(v) for v in node]
    return node


def _resolve(node: Any, root: Config) -> Any:
    if isinstance(node, dict):
        for k in list(node.keys()):
            node[k] = _resolve(node[k], root)
        return node
    if isinstance(node, list):
        return [_resolve(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP.fullmatch(node)
        if m:  # whole-value interpolation keeps the referenced type
            val = root.select(m.group(1))
            if val is None:
                raise KeyError(f"unresolvable interpolation: {node}")
            return _resolve(val, root)
        def sub(match):
            val = root.select(match.group(1))
            if val is None:
                raise KeyError(f"unresolvable interpolation: {match.group(0)}")
            return str(_resolve(val, root))
        return _INTERP.sub(sub, node)
    return node


def load_config(path: str) -> Config:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    cfg = _wrap(raw or {})
    _resolve(cfg, cfg)
    return cfg


def loads_config(text: str) -> Config:
    import yaml

    cfg = _wrap(yaml.safe_load(text) or {})
    _resolve(cfg, cfg)
    return cfg

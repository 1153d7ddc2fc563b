"""YAML config with ``${a.b}`` interpolation (OmegaConf-style, stdlib-only).

The reference uses OmegaConf YAML with variable interpolation
(conf/cfg_train_DNS3.yaml:28-30, cfg_infer.yaml:12-15) and splats config dicts
into constructors.  Neither OmegaConf nor PyYAML is needed here: this module
reads and writes the YAML subset the configs use, and adds dotted access and
``${path.to.key}`` interpolation.

The subset: block mappings and block sequences by indentation, plain,
single- and double-quoted scalars, full-line and inline comments, empty
values and the empty flow collections ``[]`` and ``{}``.  Scalars resolve
as PyYAML's ``safe_load`` resolves them (YAML 1.1): ``1e-3`` has no dot, so
it is the string ``'1e-3'``; ``1.0e-3`` is a float; ``yes``/``off`` are
bools; ``~``, ``null`` and an empty value are None.  Anything outside the
subset (anchors, tags, block scalars, multi-line flow) raises ``ValueError``.
"""

from __future__ import annotations

import math
import re
from typing import Any

_INTERP = re.compile(r"\$\{([^}]+)\}")

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = {"yes", "true", "on"}


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


# ---------------------------------------------------------------------------
# the YAML subset: scalars
# ---------------------------------------------------------------------------


def _sexagesimal(text: str, conv) -> Any:
    sign = -1 if text[0] == "-" else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + conv(part)
    return sign * value


def _yaml_int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    body = t.lstrip("+-")
    if ":" in body:
        return _sexagesimal(t, int)
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body != "0" and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _yaml_float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t[0] == "-" else 1.0
    body = t.lstrip("+-")
    if body == ".inf":
        return sign * math.inf
    if body == ".nan":
        return math.nan
    if ":" in body:
        return _sexagesimal(t, float)
    return sign * float(body)


def _plain(text: str) -> Any:
    """A plain scalar, resolved as PyYAML's ``safe_load`` resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _yaml_int(text)
    if _FLOAT.match(text):
        return _yaml_float(text)
    if _TIMESTAMP.match(text):
        raise ValueError(f"YAML timestamps are outside the supported subset: {text!r}")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _double_quoted(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in "xuU":
            n = {"x": 2, "u": 4, "U": 8}[e]
            out.append(chr(int(body[i + 2 : i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"unsupported escape \\{e} in {body!r}")
    return "".join(out)


def _quoted_end(text: str) -> int:
    """The index just past the closing quote of the scalar ``text`` opens."""
    q, i = text[0], 1
    while i < len(text):
        if q == "'" and text[i] == "'":
            if text[i + 1 : i + 2] == "'":
                i += 2
                continue
            return i + 1
        if q == '"' and text[i] == "\\":
            i += 2
            continue
        if q == '"' and text[i] == '"':
            return i + 1
        i += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


def _scalar(text: str) -> Any:
    """A value: quoted or plain scalar, or an empty flow collection."""
    if not text:
        return None
    if text[0] in "'\"":
        end = _quoted_end(text)
        if text[end:].strip():
            raise ValueError(f"text after a quoted scalar: {text!r}")
        body = text[1 : end - 1]
        return body.replace("''", "'") if text[0] == "'" else _double_quoted(body)
    if text == "[]":
        return []
    if text == "{}":
        return {}
    if text[0] in "[{&*!|>%@`":
        raise ValueError(f"outside the supported YAML subset: {text!r}")
    return _plain(text)


# ---------------------------------------------------------------------------
# the YAML subset: structure
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        if c in "'\"" and (i == 0 or line[i - 1] in " \t:-[{,"):
            i += _quoted_end(line[i:])
            continue
        i += 1
    return line.rstrip()


def _split_key(text: str) -> tuple[str, str] | None:
    """``key: value`` -> (key, value text); None when ``text`` is no mapping
    entry."""
    if text[0] in "'\"":
        end = _quoted_end(text)
        rest = text[end:]
        if rest == ":" or rest.startswith(": "):
            return text[:end], rest[1:].strip()
        return None
    m = re.search(r":(?: |$)", text)
    if m is None:
        return None
    return text[: m.start()].rstrip(), text[m.end():].strip()


def _lines(text: str) -> list[tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.strip() in ("---", "..."):
            raise ValueError("YAML documents markers are outside the supported subset")
        out.append((len(body) - len(body.lstrip(" ")), body.strip()))
    return out


class _Parser:
    def __init__(self, text: str):
        self.lines = _lines(text)
        self.i = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        indent = self.lines[0][0]
        value = self.block(indent)
        if self.i != len(self.lines):
            raise ValueError(f"bad indentation at {self.lines[self.i][1]!r}")
        return value

    def block(self, indent: int) -> Any:
        ind, text = self.lines[self.i]
        if ind != indent:
            raise ValueError(f"bad indentation at {text!r}")
        if text == "-" or text.startswith("- "):
            return self.sequence(indent)
        if _split_key(text) is not None:
            return self.mapping(indent)
        self.i += 1
        return _scalar(text)

    def nested(self, indent: int, allow_sequence: bool) -> Any:
        """The block after ``key:`` or ``-`` with nothing on its line: deeper
        lines, or (after a key) a sequence at the key's own indentation."""
        if self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind > indent or (allow_sequence and ind == indent
                                and (text == "-" or text.startswith("- "))):
                return self.block(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent:
                break
            kv = _split_key(text) if ind == indent else None
            if kv is None:
                raise ValueError(f"bad mapping entry {text!r}")
            key, rest = _scalar(kv[0]), kv[1]
            self.i += 1  # a repeated key overwrites, as in PyYAML
            out[key] = _scalar(rest) if rest else self.nested(indent, allow_sequence=True)
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            is_entry = text == "-" or text.startswith("- ")
            if ind < indent or (ind == indent and not is_entry):
                break  # a sequence under a key may sit at the key's indentation
            if ind > indent:
                raise ValueError(f"bad sequence entry {text!r}")
            rest = text[1:].strip()
            if not rest:
                self.i += 1
                out.append(self.nested(indent, allow_sequence=False))
                continue
            # "- key: value" opens a mapping whose entries sit at the dash + 2
            inner = indent + len(text) - len(rest)
            self.lines[self.i] = (inner, rest)
            out.append(self.block(inner))
        return out


def parse_yaml(text: str) -> Any:
    """``text`` in the supported YAML subset -> Python values, equal to
    ``yaml.safe_load(text)`` type for type."""
    return _Parser(text).parse()


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:  # 1e-05 would read back as a string
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if any(ord(c) < 32 or c == "\x7f" for c in v):
            return '"' + "".join(c if c not in '\\"' and 32 <= ord(c) != 0x7F
                                 else f"\\{c}" if c in '\\"' else f"\\x{ord(c):02x}"
                                 for c in v) + '"'
        try:
            plain = (v == v.strip() and _scalar(v) == v and _strip_comment(v) == v
                     and _split_key(v) is None and not v.startswith(("- ", "#")))
        except (ValueError, IndexError):
            plain = False
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def dump_yaml(data: Any, indent: int = 0) -> str:
    """Block-style YAML of nested dicts, lists and scalars, which
    :func:`parse_yaml` (and ``yaml.safe_load``) read back equal."""
    pad = " " * indent
    if isinstance(data, dict):
        if not data:
            return pad + "{}\n"
        out = []
        for k, v in data.items():
            key = _dump_scalar(k)
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{key}:\n" + dump_yaml(v, indent + 2))
            else:
                out.append(f"{pad}{key}: {dump_yaml(v).strip()}\n")
        return "".join(out)
    if isinstance(data, list):
        if not data:
            return pad + "[]\n"
        out = []
        for v in data:
            if isinstance(v, (dict, list)) and v:
                body = dump_yaml(v, indent + 2)
                out.append(f"{pad}- " + body[indent + 2 :])
            else:
                out.append(f"{pad}- {dump_yaml(v).strip()}\n")
        return "".join(out)
    return pad + _dump_scalar(data) + "\n"


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


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


def loads_config(text: str) -> Config:
    cfg = _wrap(parse_yaml(text) or {})
    _resolve(cfg, cfg)
    return cfg


def load_config(path: str) -> Config:
    with open(path) as f:
        return loads_config(f.read())


def save_config(config: dict, path: str) -> None:
    """Write ``config`` (nested dicts, lists, scalars) as YAML that
    :func:`load_config` reads back equal."""
    with open(path, "w") as f:
        f.write(dump_yaml(dict(config)))

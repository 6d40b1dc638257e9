"""YAML config parsing with the reference's two-file ``/shared/`` routing
(port of ``ocean_perception_tpu.config.yaml_parser``).

Reference parity: src/vehicle/params/yaml_parser.hpp:21-80. The reference
reads OpenCV FileStorage YAML (a leading ``%YAML:1.0`` directive,
``!!opencv-matrix`` ``{rows, cols, data}`` nodes). The JAX package reads it
with PyYAML; this port reads it with its own reader of the YAML subset the
node and rig files use, so a machine without PyYAML can run the nodes:

- block mappings and block sequences (a sequence item may open a mapping,
  ``- id: 0``), nested by indentation;
- flow sequences, nested and spread over several lines;
- plain, single- and double-quoted scalars, resolved as PyYAML's
  ``safe_load`` resolves them (YAML 1.1: ``~``/``null`` is None,
  ``yes``/``no``/``on``/``off``/``true``/``false`` are booleans, ``0x``,
  ``0b``, ``0``-octal and ``1:30`` sexagesimal integers, a float needs a
  dot, so ``1e-3`` stays a string);
- comments, the ``%YAML`` directive, ``---``/``...`` markers and the
  ``!!opencv-matrix`` tag.

Anything else (anchors, block scalars, flow mappings, other tags, dates)
raises ``ValueError`` rather than being read some other way.

Lookups: a parser owns a *node* tree and an optional *shared* tree; ids are
``a/b/c`` paths, and ids starting with ``/shared/`` route to the shared
tree (rig calibration). ``subtree(id)`` keeps the shared routing.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

import numpy as np

_DIRECTIVE_RE = re.compile(r"^%YAML[:\s].*$", re.MULTILINE)

# PyYAML's implicit resolvers for YAML 1.1 (resolver.py), in its order.
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_DATE_RE = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_BOOLS = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


def _sexagesimal(value: str, cast):
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    digits = [cast(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for d in digits:
        out += d * base
        base *= 60
    return sign * out


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _plain(text: str) -> Any:
    """A plain scalar, resolved as PyYAML's safe_load does."""
    if _NULL_RE.match(text):
        return None
    if _BOOL_RE.match(text):
        return _BOOLS[text.lower()]
    if _INT_RE.match(text):
        return _int(text)
    if _FLOAT_RE.match(text):
        return _float(text)
    if _DATE_RE.match(text):
        raise ValueError(f"YAML timestamps are not supported: {text!r}")
    if text[0] in "&*!|>%@`{":
        raise ValueError(f"unsupported YAML construct: {text!r}")
    return text


def _quoted(text: str, start: int) -> Tuple[str, int]:
    """The quoted scalar at text[start] and the index past its closing quote."""
    q = text[start]
    out, i = [], start + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[e]
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            if e not in _ESCAPES:
                raise ValueError(f"bad escape in {text!r}")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


def _scalar(text: str) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, 0)
        if text[end:].strip():
            raise ValueError(f"text after a quoted scalar: {text!r}")
        return value
    return _plain(text)


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """The flow node at text[i] (a sequence or a scalar) and the index past it."""
    while text[i] == " ":
        i += 1
    if text[i] == "{":
        raise ValueError(f"flow mappings are not supported: {text!r}")
    if text[i] in ("'", '"'):
        value, i = _quoted(text, i)
        return value, i
    if text[i] != "[":
        j = i
        while j < len(text) and text[j] not in ",]":
            j += 1
        return _plain(text[i:j].strip()), j
    items, i = [], i + 1
    while True:
        while text[i] == " ":
            i += 1
        if text[i] == "]":
            return items, i + 1
        item, i = _flow(text, i)
        items.append(item)
        while text[i] == " ":
            i += 1
        if text[i] == ",":
            i += 1
        elif text[i] != "]":
            raise ValueError(f"bad flow sequence: {text!r}")


def _flow_value(text: str) -> Any:
    value, end = _flow(text, 0)
    if text[end:].strip():
        raise ValueError(f"text after a flow sequence: {text!r}")
    return value


def _strip_comment(line: str) -> str:
    """The line without its comment (a # at its start or after a blank,
    outside quotes), right-stripped."""
    quote, i = None, 0
    while i < len(line):
        c = line[i]
        if quote:
            if quote == '"' and c == "\\":
                i += 1  # the escaped character
            elif c == quote and quote == "'" and line[i + 1:i + 2] == "'":
                i += 1  # '' inside single quotes
            elif c == quote:
                quote = None
        elif c in ("'", '"') and (i == 0 or line[i - 1] in " [,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _depth(text: str) -> int:
    """Open brackets of text, outside quotes."""
    depth, quote = 0, None
    for c in text:
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"'):
            quote = c
        elif c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
    return depth


def _lines(text: str) -> List[Tuple[int, str]]:
    """(indent, content) of each content line; a flow sequence spread over
    several lines is joined into its first."""
    out: List[Tuple[int, str]] = []
    open_brackets = 0
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in indentation are not valid YAML")
        line = _strip_comment(raw)
        content = line.strip()
        if open_brackets > 0:
            if content:
                out[-1] = (out[-1][0], out[-1][1] + " " + content)
                open_brackets += _depth(content)
            continue
        if not content or content in ("---", "..."):
            continue
        if content.startswith("--- "):
            content = content[4:].strip()
        out.append((len(line) - len(line.lstrip()), content))
        open_brackets = _depth(content)
    if open_brackets > 0:
        raise ValueError("unterminated flow sequence")
    return out


def _split_key(content: str) -> Optional[Tuple[str, str]]:
    """(key, rest) of a mapping entry 'key: rest', or None."""
    quote, depth = None, 0
    for i, c in enumerate(content):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"') and i == 0:
            quote = c
        elif c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(content) or content[i + 1] == " "):
            return content[:i], content[i + 1:].strip()
    return None


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Reader:
    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines
        self.i = 0

    def block(self, indent: int) -> Any:
        col, content = self.lines[self.i]
        if _is_item(content):
            return self.sequence(col)
        if _split_key(content) is None:
            self.i += 1
            return self.value(content)
        return self.mapping(col)

    def value(self, rest: str) -> Any:
        return _flow_value(rest) if rest.startswith("[") else _scalar(rest)

    def nested(self, indent: int, allow_sequence: bool) -> Any:
        """The node under a key or item that ends its line, or None."""
        if self.i < len(self.lines):
            col, content = self.lines[self.i]
            if col > indent or (allow_sequence and col == indent and _is_item(content)):
                return self.block(col)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            col, content = self.lines[self.i]
            if col < indent or (col == indent and _is_item(content)):
                break
            if col > indent:
                raise ValueError(f"bad indentation at {content!r}")
            kv = _split_key(content)
            if kv is None:
                raise ValueError(f"expected 'key: value', got {content!r}")
            key, rest = _scalar(kv[0]), kv[1]
            self.i += 1
            out[key] = self.nested(indent, True) if rest == "" else self.value(rest)
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            col, content = self.lines[self.i]
            if col != indent or not _is_item(content):
                if col > indent:
                    raise ValueError(f"bad indentation at {content!r}")
                break
            rest = content[1:].lstrip()
            if rest == "":
                self.i += 1
                out.append(self.nested(indent, False))
            elif _split_key(rest) is not None and not rest.startswith("["):
                # "- key: value" opens a mapping at the column of its key.
                self.lines[self.i] = (col + len(content) - len(rest), rest)
                out.append(self.mapping(col + len(content) - len(rest)))
            elif _is_item(rest):
                self.lines[self.i] = (col + len(content) - len(rest), rest)
                out.append(self.sequence(col + len(content) - len(rest)))
            else:
                self.i += 1
                out.append(self.value(rest))
        return out


def parse_yaml(text: str) -> Any:
    """The YAML subset of the module docstring, as PyYAML's safe_load reads it."""
    reader = _Reader(_lines(text))
    if not reader.lines:
        return None
    node = reader.block(reader.lines[0][0])
    if reader.i != len(reader.lines):
        raise ValueError(f"unexpected content: {reader.lines[reader.i][1]!r}")
    return node


def load_opencv_yaml(path: str) -> dict:
    """Read an OpenCV-style YAML file into plain Python containers."""
    with open(path, "r") as f:
        text = f.read()
    text = _DIRECTIVE_RE.sub("", text)
    # OpenCV writes `!!opencv-matrix` tags; the matrix is its mapping.
    text = text.replace("!!opencv-matrix", "")
    data = parse_yaml(text)
    return data if data is not None else {}


def _convert(node: Any) -> Any:
    """Convert {rows, cols, data} matrix nodes into numpy arrays."""
    if isinstance(node, dict) and {"rows", "cols", "data"} <= set(node.keys()):
        arr = np.asarray(node["data"], dtype=np.float64)
        return arr.reshape(int(node["rows"]), int(node["cols"]))
    return node


class YamlParser:
    """Two-tree YAML lookup with `/shared/` routing (yaml_parser.hpp:36-180)."""

    SHARED_PREFIX = "/shared/"

    def __init__(
        self,
        node_path: Optional[str] = None,
        shared_path: Optional[str] = None,
        node_tree: Optional[dict] = None,
        shared_tree: Optional[dict] = None,
    ):
        if node_path is not None:
            node_tree = load_opencv_yaml(node_path)
        if shared_path is not None:
            shared_tree = load_opencv_yaml(shared_path)
        self._node = node_tree if node_tree is not None else {}
        self._shared = shared_tree if shared_tree is not None else {}

    # -- lookup ---------------------------------------------------------------

    def _resolve(self, tree: Any, path: str) -> Any:
        cur = tree
        for part in path.strip("/").split("/"):
            if not isinstance(cur, dict) or part not in cur:
                raise KeyError(path)
            cur = cur[part]
        return _convert(cur)

    def has(self, id_: str) -> bool:
        try:
            self.get(id_)
            return True
        except KeyError:
            return False

    def get(self, id_: str, default: Any = ...) -> Any:
        """Fetch a value; ids starting with /shared/ hit the shared tree."""
        try:
            if id_.startswith(self.SHARED_PREFIX):
                return self._resolve(self._shared, id_[len(self.SHARED_PREFIX):])
            return self._resolve(self._node, id_)
        except KeyError:
            if default is not ...:
                return default
            raise KeyError(id_) from None

    def subtree(self, id_: str) -> "YamlParser":
        """Sub-parser rooted at id_ in the node tree; shared tree carries over."""
        sub = self._resolve(self._node, id_)
        if not isinstance(sub, dict):
            raise KeyError(f"{id_} is not a mapping")
        return YamlParser(node_tree=sub, shared_tree=self._shared)

    # -- typed helpers (YamlToVector / YamlToMatrix / YamlToStereoRig) --------

    def get_vector(self, id_: str, size: Optional[int] = None) -> np.ndarray:
        v = np.asarray(self.get(id_), dtype=np.float64).reshape(-1)
        if size is not None and v.size != size:
            raise ValueError(f"{id_}: expected {size} elements, got {v.size}")
        return v

    def get_matrix(self, id_: str, rows: int, cols: int) -> np.ndarray:
        m = np.asarray(self.get(id_), dtype=np.float64)
        return m.reshape(rows, cols)

    def get_transform(self, id_: str) -> np.ndarray:
        return self.get_matrix(id_, 4, 4)

    def get_enum(self, id_: str, mapping: dict, default: Any = ...) -> Any:
        key = self.get(id_, default=None)
        if key is None:
            if default is not ...:
                return default
            raise KeyError(id_)
        return mapping[str(key)]

    def get_camera(self, id_: str):
        """Load a PinholeCamera from a camera node (YamlToCameraModel parity).

        Expects keys: image_height, image_width, intrinsics [fx, fy, cx, cy].
        """
        from ..core.cameras import PinholeCamera

        sub = f"{id_}/" if id_ else ""
        h = int(self.get(f"{sub}image_height"))
        w = int(self.get(f"{sub}image_width"))
        fx, fy, cx, cy = self.get_vector(f"{sub}intrinsics", 4)
        return PinholeCamera.create(fx, fy, cx, cy, h, w)

    def get_stereo_rig(self, id_: str = "/shared/stereo_forward"):
        """Load a StereoCamera from a stereo rig node (YamlToStereoRig parity).

        Baseline = |t_left - t_right| from the two body_T_cam extrinsics.
        """
        from ..core.cameras import StereoCamera

        cam_l = self.get_camera(f"{id_}/camera_left")
        cam_r = self.get_camera(f"{id_}/camera_right")
        T_l = self.get_transform(f"{id_}/camera_left/body_T_cam")
        T_r = self.get_transform(f"{id_}/camera_right/body_T_cam")
        baseline = float(np.linalg.norm(T_l[:3, 3] - T_r[:3, 3]))
        return StereoCamera.create(cam_l, cam_r, baseline), T_l, T_r

"""Dataclass-based params with recursive YAML loading (a copy of
``ocean_perception_tpu.config.params``).

Reference parity: src/vehicle/params/params_base.hpp and the MACRO_PARAMS
pattern (params/README.md): every module owns a ``Params`` struct with inline
defaults, loadable from a YAML subtree that mirrors class composition, with
``/shared/`` ids routed to the rig-calibration file.

Rebuild design: plain Python dataclasses + a ``@params`` decorator. Fields
are loaded by name from the parser subtree; fields whose type is itself a
params dataclass recurse into the same-named subtree. Fields may customize
their YAML id or mark themselves shared via ``metadata``:

    @params
    class MyParams(ParamsBase):
        alpha: float = 0.9
        n_gravity: np.ndarray = field_vector(3, [0, 9.81, 0], yaml_id="/shared/n_gravity")
        tracker: StereoTrackerParams = subparams(StereoTrackerParams, "StereoTracker")
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Type, TypeVar

import numpy as np

from .yaml_parser import YamlParser

P = TypeVar("P", bound="ParamsBase")


def params(cls):
    """Decorator: make a ParamsBase subclass a dataclass."""
    return dataclasses.dataclass(cls)


def field_vector(size: int, default, yaml_id: Optional[str] = None):
    return dataclasses.field(
        default_factory=lambda: np.asarray(default, dtype=np.float64),
        metadata={"kind": "vector", "size": size, "yaml_id": yaml_id},
    )


def field_matrix(rows: int, cols: int, default=None, yaml_id: Optional[str] = None):
    if default is None:
        default = np.eye(rows, cols)
    return dataclasses.field(
        default_factory=lambda: np.asarray(default, dtype=np.float64),
        metadata={"kind": "matrix", "rows": rows, "cols": cols, "yaml_id": yaml_id},
    )


def subparams(sub_cls, subtree: Optional[str] = None):
    return dataclasses.field(
        default_factory=sub_cls,
        metadata={"kind": "subparams", "cls": sub_cls, "subtree": subtree},
    )


class ParamsBase:
    """Base for all params dataclasses (params_base.hpp:12-36)."""

    @classmethod
    def load(cls: Type[P], parser: YamlParser) -> P:
        """Build params from a parser, falling back to field defaults."""
        kwargs = {}
        for f in dataclasses.fields(cls):  # type: ignore[arg-type]
            meta = f.metadata or {}
            kind = meta.get("kind")
            if kind == "subparams":
                sub_cls = meta["cls"]
                subtree_id = meta.get("subtree") or sub_cls.__name__.replace("Params", "")
                try:
                    sub_parser = parser.subtree(subtree_id)
                except KeyError:
                    kwargs[f.name] = sub_cls()
                    continue
                kwargs[f.name] = sub_cls.load(sub_parser)
                continue

            yaml_id = meta.get("yaml_id") or f.name
            if not parser.has(yaml_id):
                continue  # keep default
            if kind == "vector":
                kwargs[f.name] = parser.get_vector(yaml_id, meta["size"])
            elif kind == "matrix":
                kwargs[f.name] = parser.get_matrix(yaml_id, meta["rows"], meta["cols"])
            else:
                value = parser.get(yaml_id)
                kwargs[f.name] = _coerce(value, f.type)
        return cls(**kwargs)  # type: ignore[call-arg]

    @classmethod
    def from_files(cls: Type[P], node_path: str, shared_path: Optional[str] = None) -> P:
        return cls.load(YamlParser(node_path=node_path, shared_path=shared_path))


def _coerce(value: Any, annot: Any) -> Any:
    """Coerce YAML scalars to the annotated field type (bools come as 0/1)."""
    name = annot if isinstance(annot, str) else getattr(annot, "__name__", "")
    if name == "bool":
        return bool(value)
    if name == "int":
        return int(value)
    if name == "float":
        return float(value)
    if name == "str":
        return str(value)
    return value

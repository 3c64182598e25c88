"""Layered configuration: a YAML file plus ``--key value`` CLI overrides onto
dataclasses (the port's copy of ``karanta_tpu/config.py``).

If argv[0] ends with .yaml/.yml it is loaded as the base config; the
remaining ``--k v`` pairs override it with type casting (int, float, bool,
List[str]) and duplicate detection. Each field name belongs to one of the
dataclasses it fills.
"""

from __future__ import annotations

import dataclasses
import sys
import typing
from pathlib import Path
from typing import Any, Iterable, Sequence, Type, TypeVar

import yaml

T = TypeVar("T")


def load_yaml_config(path: str | Path) -> dict:
    with open(path, "r") as stream:
        loaded = yaml.safe_load(stream)
    return loaded or {}


def _cast(value: str, annot: Any) -> Any:
    origin = typing.get_origin(annot)
    if origin is typing.Union:
        args = [a for a in typing.get_args(annot) if a is not type(None)]
        if len(args) == 1:
            if value.lower() in ("none", "null"):
                return None
            return _cast(value, args[0])
        return value
    if origin in (list, typing.List):
        (elem,) = typing.get_args(annot) or (str,)
        return [_cast(v.strip(), elem) for v in value.split(",") if v.strip()]
    if annot is bool or annot == "bool":
        if value.lower() in ("true", "1", "yes"):
            return True
        if value.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"Cannot parse bool from {value!r}")
    if annot is int or annot == "int":
        return int(value)
    if annot is float or annot == "float":
        return float(value)
    return value


def _field_map(cls: Type) -> dict[str, dataclasses.Field]:
    return {f.name: f for f in dataclasses.fields(cls)}


def parse_cli_overrides(argv: Sequence[str]) -> dict[str, str]:
    """Parse ``--key value`` / ``--key=value`` pairs; reject duplicates."""
    overrides: dict[str, str] = {}
    i = 0
    args = list(argv)
    while i < len(args):
        tok = args[i]
        if not tok.startswith("--"):
            raise ValueError(f"Expected --key, got {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(args):
                raise ValueError(f"Missing value for --{key}")
            value = args[i + 1]
            i += 2
        if key in overrides:
            raise ValueError(f"Duplicate CLI override --{key}")
        overrides[key] = value
    return overrides


def build_dataclass(cls: Type[T], data: dict[str, Any]) -> T:
    """Construct a (possibly nested) dataclass from a dict, ignoring extras."""
    fields = _field_map(cls)
    kwargs: dict[str, Any] = {}
    for name, value in data.items():
        if name not in fields:
            continue
        annot = fields[name].type
        if isinstance(annot, str):  # from __future__ annotations
            annot = typing.get_type_hints(cls).get(name, str)
        if dataclasses.is_dataclass(annot) and isinstance(value, dict):
            value = build_dataclass(annot, value)
        kwargs[name] = value
    return cls(**kwargs)


class ConfigParser:
    """Parses [config.yaml] [--overrides...] into one or more dataclasses.

    With multiple dataclass types, each field name must be unique across the
    set; YAML keys and CLI overrides are routed to whichever dataclass owns
    the field (mirroring HfArgumentParser multi-dataclass behaviour used at
    reference ocr_training.py:815-818).
    """

    def __init__(self, dataclass_types: Type | Iterable[Type]):
        if isinstance(dataclass_types, type):
            dataclass_types = [dataclass_types]
        self.types = list(dataclass_types)
        owners: dict[str, Type] = {}
        for cls in self.types:
            for name in _field_map(cls):
                if name in owners:
                    raise ValueError(
                        f"Field {name!r} defined by both {owners[name].__name__}"
                        f" and {cls.__name__}")
                owners[name] = cls
        self._owners = owners

    def parse(self, argv: Sequence[str] | None = None):
        argv = list(sys.argv[1:] if argv is None else argv)
        base: dict[str, Any] = {}
        if argv and (argv[0].endswith(".yaml") or argv[0].endswith(".yml")):
            base = load_yaml_config(argv[0])
            argv = argv[1:]
        overrides = parse_cli_overrides(argv)

        per_cls: dict[Type, dict[str, Any]] = {cls: {} for cls in self.types}
        for key, value in base.items():
            owner = self._owners.get(key)
            if owner is not None:
                per_cls[owner][key] = value
        for key, raw in overrides.items():
            owner = self._owners.get(key)
            if owner is None:
                raise ValueError(f"Unknown config key --{key}")
            fields = _field_map(owner)
            annot = typing.get_type_hints(owner).get(key, fields[key].type)
            per_cls[owner][key] = _cast(raw, annot)

        out = tuple(build_dataclass(cls, data) for cls, data in per_cls.items())
        return out[0] if len(out) == 1 else out

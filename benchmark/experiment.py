"""Experiment configurations built from a configuration's and a traffic
mix's JSON: the factory the configuration names, called with its arguments,
then the overrides of the configuration and of the mix, field by field."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Mapping

ROOT = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> Dict[str, Any]:
    """`benchmark/<kind>/<name>.json` as a dict."""
    path = ROOT / kind / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def reference(config_name: str) -> ModuleType:
    """The plain reference of a configuration, `benchmark/reference/<name>.py`."""
    return importlib.import_module(f"benchmark.reference.{config_name}")


def _as_field(value: Any) -> Any:
    """JSON lists become the tuples the dataclasses hold."""
    if isinstance(value, list):
        return tuple(_as_field(v) for v in value)
    return value


def replace(obj: Any, overrides: Mapping[str, Any]) -> Any:
    """`obj` with `overrides` applied: a dict goes into the dataclass field
    of its key, anything else replaces the field."""
    changes = {}
    for key, value in overrides.items():
        if not any(f.name == key for f in dataclasses.fields(obj)):
            raise KeyError(f"{type(obj).__name__} has no field {key!r}")
        current = getattr(obj, key)
        if isinstance(value, dict) and dataclasses.is_dataclass(current):
            changes[key] = replace(current, value)
        else:
            changes[key] = _as_field(value)
    return dataclasses.replace(obj, **changes)


def build(config_module: ModuleType, config: Mapping[str, Any], traffic: Mapping[str, Any],
          *extra: Mapping[str, Any]) -> Any:
    """The experiment of `config` under `traffic` from the factories of
    `config_module` (the program's `config` or the reference's); each of
    `extra` overrides in turn (the tests shrink the widths with one)."""
    cfg = getattr(config_module, config["factory"])(**config.get("factory_args", {}))
    for overrides in (config.get("overrides", {}), traffic.get("overrides", {}), *extra):
        cfg = replace(cfg, overrides)
    return cfg


def mismatches(program: Any, frozen: Any, path: str = "") -> List[str]:
    """Each field of `frozen` (the reference's configuration, field by field
    down its nested dataclasses) whose value `program` does not share, as
    "path: program value, reference value"."""
    out = []
    for f in dataclasses.fields(frozen):
        want = getattr(frozen, f.name)
        got = getattr(program, f.name, "<missing>")
        if dataclasses.is_dataclass(want) and dataclasses.is_dataclass(got):
            out += mismatches(got, want, f"{path}{f.name}.")
        elif got != want:
            out.append(f"{path}{f.name}: program {got!r}, reference {want!r}")
    return out

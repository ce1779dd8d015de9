"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the harness reads ``configs/<config>.json`` (the file the
configuration's entry names), ``traffic/<traffic>.json`` and
``cells/<workload>.json`` (the batch, how many requests the check compares,
and the limits of the numbers it compares).  A per-layer metric is read by
``metrics/<metric>.py``, a module with ``read(run) -> float | None``.  A
later change adds a configuration, a mix, a cell or a metric by adding
files and entries, and edits no file that is here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

from .traffic import Traffic

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict                # the configuration file, whole
    traffic: Traffic
    batch: int
    check_requests: int
    limits: dict                # number compared -> its limit
    end_to_end: tuple           # the manifest's end-to-end metric entries for this cell
    per_layer: tuple            # the same, per-layer

    @property
    def model(self) -> dict:
        return self.config["model"]


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _named(entries, name: str, what: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"{what} name {name!r} is not a valid name")
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"unknown {what} {name!r}; the manifest has "
                       f"{sorted(e['name'] for e in entries)}")
    return found[0]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: pathlib.Path = ROOT, manifest: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root``'s manifest, with every file it
    names read; ``KeyError`` for a name the manifest lacks and
    ``FileNotFoundError`` for a file that is missing."""
    m = load_manifest(root) if manifest is None else manifest
    w = _named(m["workloads"], workload, "workload")
    conf_entry = _named(m["configs"], w["config"], "configuration")
    conf = json.loads((root / conf_entry["file"]).read_text())
    traffic = Traffic.from_file(root / "perfbench" / "traffic" / f"{_checked(w['traffic'])}.json")
    spec = json.loads((root / "perfbench" / "cells" / f"{workload}.json").read_text())
    return Cell(workload, w["chips"], conf, traffic, spec["batch"], spec["check_requests"],
                spec["limits"], tuple(e for e in m["end_to_end"] if _applies(e, workload)),
                tuple(e for e in m["per_layer"] if _applies(e, workload)))


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a valid name")
    return name


def reader(metric: str, root: pathlib.Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{_checked(metric)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for the per-layer metric {metric!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

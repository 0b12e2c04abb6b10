"""What one cell is, read from data: ``BENCHMARK.json`` at the root of the
checkout names the cell's configuration and traffic mix, which are files
under ``perfbench/configs/`` and ``perfbench/traffic/``; the cell's kernel
names (for the trace readers) are in ``perfbench/cells/<cell>.json``; each
metric is read by ``perfbench/metrics/<metric>.py``; the traffic file's
``entry`` names the module under ``perfbench/entries/`` that drives it."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["HERE", "ROOT", "Spec", "load", "reader"]


@dataclasses.dataclass
class Spec:
    cell: dict
    config: dict
    traffic: dict
    kernels: dict
    end_to_end: list
    per_layer: list
    chips: int

    @property
    def name(self) -> str:
        return self.cell["name"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(cell: str, bench: dict | None = None) -> Spec:
    """The cell named ``cell`` of ``bench`` (default: the checkout's
    ``BENCHMARK.json``), with its files read."""
    if bench is None:
        bench = _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Spec(
        cell=entry,
        config=_json(ROOT / config["file"]),
        traffic=_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        kernels=_json(HERE / "cells" / f"{cell}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, cell)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, cell)],
        chips=int(entry["chips"]),
    )


def reader(metric: str):
    """The ``read(ctx)`` function of a metric, from its file."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read

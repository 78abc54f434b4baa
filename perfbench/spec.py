"""A cell of `BENCHMARK.json`, found by name: its configuration
(`configs/<config>.json`), its traffic mix (`traffic/<traffic>.json`), its
limits (`limits/<cell>.json`) and the metrics it reports."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load(REPO / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # BENCHMARK.json entries this cell reports
    per_layer: list
    chips: int = 1


def reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[
        entry["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    return Cell(name=name, config=_load(REPO / cfg_file),
                traffic=_load(HERE / "traffic" / f"{entry['traffic']}.json"),
                limits=_load(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e,
                per_layer=[m for m in bench["per_layer"]
                           if reports(m, name, names)],
                chips=entry["chips"])

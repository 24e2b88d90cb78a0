"""BENCHMARK.json and the data files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic
mix. Everything that belongs to one of them, or to one metric, sits in a
file of its own inside the benchmark's folder (`paths[0]`), found by the
name BENCHMARK.json gives:

    <folder>/traffic/<traffic>.json       a traffic mix (data)
    <folder>/metrics/<metric>.py          a metric's reader, `read(run)`;
                                          a name `a.b` falls back to a.py
    <folder>/kernels/*.py                 one hand-written kernel's bytes
                                          and operations from the shapes

A configuration's file is named by its `file` key, relative to the root.
Files are looked up in the benchmark's folder first and then in this
package's own folder, so a folder that adds one file runs with the rest.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass

PKG = pathlib.Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict            # the configuration's file
    traffic: dict           # the traffic mix's file
    chips: int
    end_to_end: list        # the end-to-end metrics this cell reports
    per_layer: list         # the per-layer metrics this cell reports
    dirs: tuple             # data folders, searched in order
    root: pathlib.Path


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(name: str, root=".") -> Cell:
    root = pathlib.Path(root).resolve()
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"({', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    dirs = tuple(dict.fromkeys([root / bench["paths"][0], PKG]))
    cfg = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(find(dirs, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, names)]
    return Cell(name=name, config=cfg, traffic=traffic, chips=w["chips"],
                end_to_end=e2e, per_layer=per_layer, dirs=dirs, root=root)


def load_parts(config: str, traffic: str, dirs=(PKG,)):
    """A configuration and a traffic mix by name, outside any cell:
    configs/<config>.json and traffic/<traffic>.json."""
    return (_load_json(find(dirs, "configs", config + ".json")),
            _load_json(find(dirs, "traffic", traffic + ".json")))


def find(dirs, sub: str, fname: str) -> pathlib.Path:
    for d in dirs:
        p = pathlib.Path(d) / sub / fname
        if p.is_file():
            return p
    raise FileNotFoundError(f"{sub}/{fname} in none of "
                            f"{[str(d) for d in dirs]}")


def _module(path: pathlib.Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(dirs, name: str):
    """The `read(run)` of metric `name`: metrics/<name>.py, or for a name
    `base.suffix` metrics/<base>.py."""
    for fname in (name + ".py", name.split(".")[0] + ".py"):
        try:
            return _module(find(dirs, "metrics", fname), "metric").read
        except FileNotFoundError:
            continue
    raise FileNotFoundError(f"no reader for metric {name!r}")


def kernel_counts(dirs) -> dict:
    """{file stem: module} of every kernels/*.py (the first folder that has
    a stem wins)."""
    out = {}
    for d in dirs:
        for p in sorted((pathlib.Path(d) / "kernels").glob("*.py")):
            if p.stem not in out and not p.stem.startswith("_"):
                out[p.stem] = _module(p, "kernel")
    return out

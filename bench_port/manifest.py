"""Finds a cell's files by the names in ``BENCHMARK.json``: the
configuration file it names, ``frontends/<frontend>.py`` by the
configuration's ``frontend``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py`` under this
directory."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    workload: dict
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: dict  # number -> limit of the output check
    end_to_end: list  # the manifest's end-to-end entries this cell reports
    per_layer: list  # the manifest's per-layer entries this cell reports
    root: str
    frontend: object  # the module of frontends/<config's frontend>.py


def _json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load(path: str, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(prefix + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frontend(name: str, root: str = ROOT):
    """The module of ``frontends/<name>.py``: the front end's keypoint
    budget, weights, the port's front end, the reference's, its part of
    the check and of the roofline (README.md)."""
    path = os.path.join(root, os.path.basename(HERE), "frontends", name + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"front end {name!r}: no file {path}")
    return _load(path, "bench_port_frontend_", name)


def _check_reference_covers(cfg: dict) -> None:
    """Refuse a configuration whose settings the reference does not
    compute: it solves PnP by DLT-6 alone and refines at scale 1 alone."""
    if cfg["pnp_minimal"] != "dlt6":
        raise ValueError(f"pnp_minimal {cfg['pnp_minimal']!r}: the reference solves \"dlt6\" only")
    if list(cfg["refine_scales"]) != [1.0]:
        raise ValueError(f"refine_scales {cfg['refine_scales']!r}: the reference refines at [1.0] only")


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s manifest with its files; raises
    ValueError, before any set-up, for a front end with no file or a
    setting the reference does not compute."""
    man = _json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    pkg = os.path.join(root, os.path.basename(HERE))
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"] if _reports(m, name) and m["moves"] in moved]
    cfg = _json(os.path.join(root, conf["file"]))
    _check_reference_covers(cfg)
    return Cell(name=name, workload=w, config=cfg, traffic=_json(os.path.join(pkg, "traffic", w["traffic"] + ".json")),
                limits=_json(os.path.join(pkg, "limits", name + ".json")), end_to_end=e2e, per_layer=per, root=root,
                frontend=frontend(cfg["frontend"], root))


def reader(metric: str, root: str = ROOT):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _load(os.path.join(root, os.path.basename(HERE), "metrics", metric + ".py"), "bench_port_metric_",
                 metric).read

"""BENCHMARK.json against the contract's rules of form, and every file a
cell needs found by its name."""

import json
import os
import re
import shutil

import pytest

from bench_port import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in man["paths"])
    assert len(man["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in man["command"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    assert len(json.dumps(man).encode()) <= 64 * 1024


def test_every_moved_metric_is_reported_where_listed(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
    for w in cells:
        cell = manifest.load_cell(w)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_every_file_is_found_by_name(man):
    for w in man["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell.limits and cell.traffic["n_frames"] > 1
        for m in cell.per_layer:
            assert callable(manifest.reader(m["name"]))
    for c in man["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
    budget = 2 + 14 * 24
    assert budget * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("key,value,named", (("pnp_minimal", "p3p", "pnp_minimal"),
                                             ("refine_scales", [1.0, 1.7], "refine_scales"),
                                             ("frontend", "no_such_matcher", "frontends/no_such_matcher.py")))
def test_load_cell_refuses_what_the_reference_does_not_compute(key, value, named, tmp_path):
    """A setting the reference does not compute, or a front end with no
    file, is refused when the cell is loaded, naming the key or the file."""
    shutil.copytree(manifest.HERE, tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    path = tmp_path / "bench_port" / "configs" / "sp_flagship.json"
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cfg, **{key: value})))
    with pytest.raises(ValueError, match=re.escape(named)):
        manifest.load_cell("sp_flagship.seq962", str(tmp_path))
    assert manifest.load_cell("orb512.seq962_c128", str(tmp_path)).config["frontend"] == "orb"

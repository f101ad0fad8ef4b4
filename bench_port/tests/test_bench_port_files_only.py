"""A cell, a configuration, a traffic mix and a per-layer metric added as
files only, in a copy of the benchmark, are found by name and run."""

import json
import os
import shutil

from bench_port import manifest, run

from bench_port.tests.conftest import TINY_TRAFFIC

METRIC = '''"""Pairs the window completed (a throwaway metric of the test)."""


def read(ctx):
    return float(ctx["window"]["pairs"])
'''


def test_cell_added_as_files_only(tmp_path):
    root = str(tmp_path)
    pkg = os.path.join(root, "bench_port")
    shutil.copytree(os.path.dirname(manifest.HERE) + "/bench_port", pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    with open(os.path.join(pkg, "configs", "orb512.json")) as f:
        cfg = json.load(f)
    cfg["orb"] = dict(cfg["orb"], n_features=64, n_levels=3)
    with open(os.path.join(pkg, "configs", "orb_small.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pkg, "traffic", "tiny.json"), "w") as f:
        json.dump(dict(json.load(open(os.path.join(pkg, "traffic", "seq962.json"))), **TINY_TRAFFIC), f)
    with open(os.path.join(pkg, "limits", "orb_small.tiny.json"), "w") as f:
        json.dump({"kp_miss": 0.0, "match_miss": 0.0, "pose_gap_mean": 1e-4}, f)
    with open(os.path.join(pkg, "metrics", "pairs_done.py"), "w") as f:
        f.write(METRIC)
    man["configs"].append(dict(name="orb_small", source="https://example.org", file="bench_port/configs/orb_small.json",
                               reduced=["orb"], why="a throwaway configuration"))
    man["workloads"].append(dict(name="orb_small.tiny", config="orb_small", traffic="tiny", chips=1, why="a test"))
    man["per_layer"].append(dict(name="pairs_done", unit="pairs", better="higher", source="program_counter",
                                 layer="device", moves="pairs_per_s", workloads=["orb_small.tiny"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    cell = manifest.load_cell("orb_small.tiny", root)
    assert cell.config["orb"]["n_features"] == 64
    result, lines = run.run_cell(cell, 9, 0.1, True, "cpu")
    assert result["correct"] is True and len(lines) == 3
    assert result["metrics"]["pairs_done"]["value"] == result["attempted"]

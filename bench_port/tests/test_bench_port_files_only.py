"""A cell, a configuration, a traffic mix, a per-layer metric and a front
end added as files only, in a copy of the benchmark, are found by name and
run."""

import json
import os
import shutil

import torch

from bench_port import manifest, run

from bench_port.tests.conftest import TINY_TRAFFIC

METRIC = '''"""Pairs the window completed (a throwaway metric of the test)."""


def read(ctx):
    return float(ctx["window"]["pairs"])
'''

# ORB with weights drawn from the seed, which it only records
FRONTEND = '''"""ORB with a weight drawn from the seed (a throwaway front end of the test)."""

import torch

from bench_port import manifest

_orb = manifest.frontend("orb")
keypoints, reference_extract, reference_match = _orb.keypoints, _orb.reference_extract, _orb.reference_match
slot_groups, desc_gap, costs, compares_obs = _orb.slot_groups, _orb.desc_gap, _orb.costs, _orb.compares_obs
SEEN = {}


def weights(cfg, root, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return {"w": torch.rand((4, 8), generator=gen, device=device)}


def program(cfg, stereo_cfg, inputs, root, device):
    SEEN["program"] = inputs["weights"]["w"]
    return _orb.program(cfg, stereo_cfg, inputs, root, device)


def reference_load(cfg, inputs, device):
    SEEN["reference"] = inputs["weights"]["w"]
    return _orb.reference_load(cfg, inputs, device)
'''


def _copy(tmp_path):
    """(root, the copy's bench_port, its manifest) of a copy of the
    benchmark without its tests."""
    root = str(tmp_path)
    pkg = os.path.join(root, "bench_port")
    shutil.copytree(manifest.HERE, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        return root, pkg, json.load(f)


def _add_orb_cell(root, pkg, man, config, frontend="orb"):
    """A tiny ORB configuration ``config`` on ``frontend`` and its cell
    ``<config>.tiny`` (the manifest written by the caller)."""
    with open(os.path.join(pkg, "configs", "orb512.json")) as f:
        cfg = json.load(f)
    cfg.update(name=config, frontend=frontend, orb=dict(cfg["orb"], n_features=64, n_levels=3))
    with open(os.path.join(pkg, "configs", config + ".json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pkg, "traffic", "seq962.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(pkg, "traffic", "tiny.json"), "w") as f:
        json.dump(dict(traffic, **TINY_TRAFFIC), f)
    with open(os.path.join(pkg, "limits", config + ".tiny.json"), "w") as f:
        json.dump({"kp_miss": 0.0, "match_miss": 0.0, "pose_gap_mean": 1e-4}, f)
    man["configs"].append(dict(name=config, source="https://example.org", file=f"bench_port/configs/{config}.json",
                               reduced=["orb"], why="a throwaway configuration"))
    man["workloads"].append(dict(name=config + ".tiny", config=config, traffic="tiny", chips=1, why="a test"))


def _write(root, man):
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)


def test_cell_added_as_files_only(tmp_path):
    root, pkg, man = _copy(tmp_path)
    _add_orb_cell(root, pkg, man, "orb_small")
    with open(os.path.join(pkg, "metrics", "pairs_done.py"), "w") as f:
        f.write(METRIC)
    man["per_layer"].append(dict(name="pairs_done", unit="pairs", better="higher", source="program_counter",
                                 layer="device", moves="pairs_per_s", workloads=["orb_small.tiny"]))
    _write(root, man)
    cell = manifest.load_cell("orb_small.tiny", root)
    assert cell.config["orb"]["n_features"] == 64
    result, lines = run.run_cell(cell, 9, 0.1, True, "cpu")
    assert result["correct"] is True and len(lines) == 3
    assert result["metrics"]["pairs_done"]["value"] == result["attempted"]


def test_front_end_added_as_files_only(tmp_path):
    """A front end with weights drawn from the seed: the port and the
    reference receive equal weights, as distinct tensors, and the run is
    correct."""
    root, pkg, man = _copy(tmp_path)
    with open(os.path.join(pkg, "frontends", "orb_seeded.py"), "w") as f:
        f.write(FRONTEND)
    _add_orb_cell(root, pkg, man, "orb_seeded_small", frontend="orb_seeded")
    _write(root, man)
    cell = manifest.load_cell("orb_seeded_small.tiny", root)
    result, lines = run.run_cell(cell, 2 ** 31 + 11, 0.1, False, "cpu")
    assert result["correct"] is True and len(lines) == 3
    seen = cell.frontend.SEEN
    drawn = cell.frontend.weights(cell.config, root, 2 ** 31 + 11, "cpu")["w"]
    assert torch.equal(seen["program"], drawn) and torch.equal(seen["reference"], drawn)
    assert seen["program"].data_ptr() != seen["reference"].data_ptr()

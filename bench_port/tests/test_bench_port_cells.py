"""Each cell at a tiny size on the CPU: the contract's result line, the
per-layer metrics of a traced run, and no result without a card."""

import json
import subprocess
import sys

import pytest
import torch

from bench_port import manifest, run

CELLS = ("sp_flagship.seq962", "orb512.seq962_c128")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("name", CELLS)
def test_cell_prints_the_result_line(name, tiny_cell):
    cell = tiny_cell(name)
    result, lines = run.run_cell(cell, 2 ** 31 + 7, 0.2, False, "cpu")
    line = json.loads(json.dumps(result))
    assert all(k in line for k in RESULT_KEYS) and list(line)[-1] == "check"
    assert line["correct"] is True and line["attempted"] >= cell.traffic["n_frames"] - 1
    assert set(line["metrics"]) == {"pairs_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    assert [ln.split()[1] for ln in lines] == list(cell.limits)


def test_traced_run_reads_the_phase_metrics(tiny_cell):
    cell = tiny_cell("orb512.seq962_c128")
    result, _ = run.run_cell(cell, 11, 0.2, True, "cpu")
    assert {"frame_phase_ms", "pair_phase_ms"} <= set(result["metrics"])
    assert "pairs_per_s" not in result["metrics"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "bench_port", "--workload", CELLS[1], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""

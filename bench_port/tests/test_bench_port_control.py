"""The check fails what it must: the control (the reference one precision
below the configuration's) and faults planted under the timed path, each
driven through the rest of a run at a tiny size on the CPU, with the cells'
own limits."""

import pytest
import torch

from bench_port import run


# the control's readings at seed 5, to the digit: moving code between the
# harness's files must leave every reading as it was
CONTROL_PINNED = {
    "sp_flagship.seq962": dict(kp_miss=0.3907815631262525, desc_gap=0.0955704003572464,
                               depth_gap=0.0008831777959130704, match_miss=0.6920353982300885,
                               obs_gap=0.17976345121860504, pose_gap_mean=0.11252422630786896,
                               traj_gap=0.22335052490234375),
    "orb512.seq962_c128": dict(kp_miss=0.06344950848972297, desc_gap=0.028022125363349915,
                               depth_gap=0.0009573543211445212, match_miss=0.48, pose_gap_mean=0.0, traj_gap=0.0),
}


@pytest.mark.parametrize("name", ("sp_flagship.seq962", "orb512.seq962_c128"))
def test_control_is_not_correct(name, tiny_cell):
    result, lines = run.run_cell(tiny_cell(name), 5, 0.0, False, "cpu", program="control")
    assert result["correct"] is False
    assert any(ln.endswith("FAIL") for ln in lines)
    assert {k: v["value"] for k, v in result["check"].items()} == CONTROL_PINNED[name]


def _fault(kind):
    """Wrap the port's per-pair step (or its chain) with one fault."""
    from forest_slam_tpu_torch.pipelines import stereo

    if kind == "state_unchanged":
        def chain(pairs, initial):
            out = stereo_chain(pairs, initial)
            return out._replace(pose=initial.expand_as(out.pose).clone())
        stereo_chain = stereo.chain_and_map
        return "chain_and_map", chain
    inner = stereo.pair_from_slab

    def pair(*args, **kwargs):
        out = inner(*args, **kwargs)
        rel = out.rel.clone()
        if kind == "half_batch":
            # the second half of the chunk's pairs left out: they repeat the first half's
            h = (rel.shape[0] + 1) // 2
            rel[h:] = rel[: rel.shape[0] - h]
        else:  # an answer altered where it is produced
            rel[0, 0, 3] += 0.05
        return out._replace(rel=rel)
    return "pair_from_slab", pair


@pytest.mark.parametrize("kind", ("state_unchanged", "half_batch", "answer_altered"))
def test_fault_is_not_correct(kind, tiny_cell, monkeypatch):
    from forest_slam_tpu_torch.pipelines import stereo

    name, fn = _fault(kind)
    monkeypatch.setattr(stereo, name, fn)
    result, _ = run.run_cell(tiny_cell("sp_flagship.seq962"), 5, 0.0, False, "cpu")
    assert result["correct"] is False


@pytest.mark.cuda
def test_program_on_the_card_is_correct_and_control_is_not(cuda_device):
    """At the cell's own size on the card: one short run is correct, the
    control is not."""
    from bench_port import manifest

    cell = manifest.load_cell("orb512.seq962_c128")
    assert run.run_cell(cell, 77, 1.0, False, cuda_device)[0]["correct"] is True
    assert run.run_cell(cell, 77, 1.0, False, cuda_device, program="control")[0]["correct"] is False
    torch.cuda.empty_cache()

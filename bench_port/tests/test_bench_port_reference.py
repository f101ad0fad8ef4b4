"""The plain reference agrees with the port at a tiny size on the CPU,
where the port runs its kernels' plain versions, and the check's readings
there are pinned to the digit."""

import pytest

from bench_port import run

# at this size the two sides run the same plain arithmetic but for batch
# shapes, so the gaps are float32 rounding at most
TINY_GAPS = dict(kp_miss=0.0, desc_gap=1e-6, depth_gap=1e-6, match_miss=0.0, obs_gap=1e-4, pose_gap_mean=1e-4,
                 traj_gap=1e-3)

# oracle.numbers of these runs, to the digit: moving code between the
# harness's files must leave every reading as it was
PINNED = {
    ("sp_flagship.seq962", 3): dict(kp_miss=0.0, desc_gap=0.0, depth_gap=0.0, match_miss=0.0,
                                    obs_gap=3.3818237099580983e-09, pose_gap_mean=7.300048565639372e-08, traj_gap=0.0),
    ("sp_flagship.seq962", 2 ** 31 + 5): dict(kp_miss=0.0, desc_gap=0.0, depth_gap=0.0, match_miss=0.0,
                                              obs_gap=3.392517200495604e-08, pose_gap_mean=9.061761829798343e-07,
                                              traj_gap=3.519111942296149e-06),
    ("orb512.seq962_c128", 3): dict(kp_miss=0.0, desc_gap=0.0, depth_gap=0.0, match_miss=0.0, pose_gap_mean=0.0,
                                    traj_gap=0.0),
    ("orb512.seq962_c128", 2 ** 31 + 5): dict(kp_miss=0.0, desc_gap=0.0, depth_gap=0.0, match_miss=0.0,
                                              pose_gap_mean=0.0, traj_gap=0.0),
}


@pytest.mark.parametrize("name", ("sp_flagship.seq962", "orb512.seq962_c128"))
@pytest.mark.parametrize("seed", (3, 2 ** 31 + 5))
def test_reference_agrees_with_the_port(name, seed, tiny_cell):
    result, _ = run.run_cell(tiny_cell(name), seed, 0.0, False, "cpu")
    for k, v in result["check"].items():
        assert v["value"] <= TINY_GAPS[k], (k, v)
    assert {k: v["value"] for k, v in result["check"].items()} == PINNED[name, seed]

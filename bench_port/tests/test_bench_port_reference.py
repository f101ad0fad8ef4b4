"""The plain reference agrees with the port at a tiny size on the CPU,
where the port runs its kernels' plain versions."""

import pytest

from bench_port import run

# at this size the two sides run the same plain arithmetic but for batch
# shapes, so the gaps are float32 rounding at most
TINY_GAPS = dict(kp_miss=0.0, desc_gap=1e-6, depth_gap=1e-6, match_miss=0.0, obs_gap=1e-4, pose_gap_mean=1e-4,
                 traj_gap=1e-3)


@pytest.mark.parametrize("name", ("sp_flagship.seq962", "orb512.seq962_c128"))
@pytest.mark.parametrize("seed", (3, 2 ** 31 + 5))
def test_reference_agrees_with_the_port(name, seed, tiny_cell):
    result, _ = run.run_cell(tiny_cell(name), seed, 0.0, False, "cpu")
    for k, v in result["check"].items():
        assert v["value"] <= TINY_GAPS[k], (k, v)

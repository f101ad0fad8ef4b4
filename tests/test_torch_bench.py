"""The port's benchmark module (forest_slam_tpu_torch/bench.py) against the
repository's bench.py, and the trajectory metrics and files it uses.

- RPE against the JAX package's ``rpe_distance_ratio`` on the same
  trajectories (the same float64 numpy arithmetic: 1e-9 relative), and
  ``read_tum``/``write_tum``/``StreamingTumWriter`` against the JAX reader
  and writer (the same text, byte for byte).
- The ping-pong frame index against bench.py's own statements, run as
  bench.py has them; the JSON fields against the names bench.py emits.
- ``vo_gate``'s worst-of-seeds rule and ``gate_failures`` with a stub run;
  the re-run-on-spread rule with a stub clock.
- A small learned workload on the CPU (96x128, 5 frames, K=64): its record.
"""

import ast
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from forest_slam_tpu.eval import metrics as jmetrics
from forest_slam_tpu.io import tum as jtum
from forest_slam_tpu_torch import bench
from forest_slam_tpu_torch.eval import metrics as tmetrics
from forest_slam_tpu_torch.io import tum as ttum
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _walk(rng, n, noise=0.0):
    """A wandering planar path with a yaw that follows it, as (N, 4, 4)."""
    steps = np.cumsum(rng.normal(0.0, 0.05, (n, 3)) + [0.0, 0.0, 0.15], axis=0)
    T = np.tile(np.eye(4), (n, 1, 1))
    yaw = np.cumsum(rng.normal(0.0, 0.02, n))
    T[:, 0, 0] = T[:, 2, 2] = np.cos(yaw)
    T[:, 0, 2], T[:, 2, 0] = np.sin(yaw), -np.sin(yaw)
    T[:, :3, 3] = steps + rng.normal(0.0, noise, (n, 3))
    return T


@pytest.mark.parametrize("delta", [1.0, 3.0, 20.0])
def test_rpe_matches_jax(delta):
    rng = np.random.default_rng(0)
    gt = _walk(rng, 120)
    est = gt.copy()
    est[:, :3, 3] += np.cumsum(rng.normal(0.0, 0.01, (120, 3)), axis=0)
    ts = np.arange(120) * 0.1
    j = jmetrics.rpe_distance_ratio(jtum.Trajectory.from_matrices(ts[1:], est[1:]),
                                    jtum.Trajectory.from_matrices(ts, gt), delta_m=delta)
    t = tmetrics.rpe_distance_ratio(ttum.Trajectory.from_matrices(ts[1:], est[1:]),
                                    ttum.Trajectory.from_matrices(ts, gt), delta_m=delta)
    assert t.n == j.n
    if j.n:
        np.testing.assert_allclose([t.rmse, t.mean, t.median, t.max], [j.rmse, j.mean, j.median, j.max], rtol=1e-9)
    else:
        assert np.isnan(t.rmse) and np.isnan(j.rmse)
    assert tmetrics.rpe_distance_ratio(ttum.Trajectory.from_matrices(ts[:1], est[:1]),
                                       ttum.Trajectory.from_matrices(ts, gt)).n == 0


def test_tum_files_round_trip_with_the_jax_reader(tmp_path):
    rng = np.random.default_rng(1)
    T = _walk(rng, 30)
    ts = 1.6e9 + np.arange(30) * 0.1
    traj = ttum.Trajectory.from_matrices(ts, T)
    ours, theirs = tmp_path / "a" / "port.txt", tmp_path / "jax.txt"
    ttum.write_tum(str(ours), traj)
    jtum.write_tum(str(theirs), jtum.Trajectory.from_matrices(ts, T))
    assert ours.read_bytes() == theirs.read_bytes()
    back = jtum.read_tum(str(ours))
    mine = ttum.read_tum(str(ours))
    for a, b in zip(mine, back):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(mine.positions, T[:, :3, 3], atol=1e-6)
    np.testing.assert_allclose(mine.quaternions, traj.quaternions, atol=1e-6)
    # comments, blank lines, commas and duplicate stamps, as the JAX reader takes them
    messy = tmp_path / "messy.txt"
    messy.write_text("# stamp x y z qx qy qz qw\n\n1.0,0,0,0,0,0,0,1\n1.0 1 2 3 0 0 0 1\nshort line\n")
    for a, b in zip(ttum.read_tum(str(messy)), jtum.read_tum(str(messy))):
        np.testing.assert_array_equal(a, b)
    assert len(ttum.read_tum(str(tmp_path / "messy.txt"))) == 2
    (tmp_path / "empty.txt").write_text("")
    assert len(ttum.read_tum(str(tmp_path / "empty.txt"))) == 0


def test_streaming_writer_matches_the_jax_writer(tmp_path):
    rng = np.random.default_rng(2)
    T = _walk(rng, 12)
    ts = np.arange(12) * 0.1
    with ttum.StreamingTumWriter(str(tmp_path / "p.txt")) as w, jtum.StreamingTumWriter(str(tmp_path / "j.txt")) as v:
        for a, b in ((0, 5), (5, 12)):
            w.append(ts[a:b], T[a:b])
            v.append(ts[a:b], T[a:b])
        assert len(ttum.read_tum(str(tmp_path / "p.txt"))) == 12  # flushed chunk by chunk
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def _bench_main():
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


@pytest.mark.parametrize("n_frames, n_unique", [(963, 64), (24, 24), (10, 1), (100, 7)])
def test_frame_index_matches_bench_py(n_frames, n_unique):
    """bench.py's ping-pong statements (the assignments to period, reps and
    frame_idx in its main), run as they stand there."""
    stmts = [n for n in ast.walk(_bench_main()) if isinstance(n, ast.Assign)
             and any(isinstance(t, ast.Name) and t.id in ("period", "reps", "frame_idx") for t in n.targets)]
    assert len(stmts) == 3
    scope = {"np": np, "n_frames": n_frames, "n_unique": n_unique}
    exec(compile(ast.Module(body=stmts, type_ignores=[]), "bench.py", "exec"), scope)
    np.testing.assert_array_equal(bench.frame_index(n_frames, n_unique), scope["frame_idx"])
    idx = bench.frame_index(n_frames, n_unique)
    assert len(idx) == n_frames and (np.abs(np.diff(idx)) <= 1).all()


def _emitted_names():
    call = next(n for n in ast.walk(_bench_main()) if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "emit")
    return {k.arg for k in call.keywords if k.arg} | {"metric", "value", "unit", "vs_baseline"}


def _outs(ok, poses):
    return SimpleNamespace(ok=torch.as_tensor(ok), pose=torch.as_tensor(poses))


def test_vo_gate_takes_the_worst_seed():
    gt = torch.as_tensor(_walk(np.random.default_rng(3), 9))
    drift = gt[1:].clone()
    drift[:, 0, 3] += torch.linspace(0.0, 1.0, 8, dtype=drift.dtype)

    def run(il, ir, rig, cfg, fe, seed):
        return _outs([True] * 8, gt[1:]) if seed == 0 else _outs([True] * 6 + [False] * 2, drift)

    gates, failures = {}, []
    bench.vo_gate("wb_k20", torch.zeros(9), None, gt, None, None, None, 6, 0.10, gates, failures, run=run)
    assert gates["wb_k20_ok"] == 6 and gates["wb_k20_n"] == 8
    assert gates["wb_k20_seeds"][0] == [8, 0.0] and gates["wb_k20_seeds"][1][0] == 6
    assert gates["wb_k20_ate"] == gates["wb_k20_seeds"][1][1] > 0.1
    assert failures == [f"wb_k20: 6/8 ok (need >=6), ATE {gates['wb_k20_ate']} (need <=0.1)"]
    gates, failures = {}, []
    bench.vo_gate("wb_k10", torch.zeros(9), None, gt, None, None, None, 8, 1.0, gates, failures, run=run)
    assert failures == [f"wb_k10: 6/8 ok (need >=8), ATE {gates['wb_k10_ate']} (need <=1.0)"]
    gates, failures = {}, []
    bench.vo_gate("ok", torch.zeros(9), None, gt, None, None, None, 6, 1.0, gates, failures, run=run)
    assert failures == [] and set(gates) == {"ok_ok", "ok_n", "ok_ate", "ok_seeds"}


def test_gate_table_follows_bench_py():
    """Tags, bounds and seeds as bench.py's vo_gate calls have them."""
    calls = {}
    for n in ast.walk(_bench_main()):
        if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "vo_gate":
            kw = {k.arg: ast.literal_eval(k.value) for k in n.keywords}
            calls[ast.literal_eval(n.args[0])] = (kw["min_ok"], kw["max_ate"])
    assert calls == {g.tag: (g.min_ok, g.max_ate) for g in bench.GATES}
    assert [g.tag for g in bench.GATES if not g.held] == ["blur_wb_k10", "plain_k20"]
    assert bench.GATE_SEEDS == (0, 1)


def test_timed_runs_rerun_on_spread():
    ticks = iter([0.0, 1.0, 1.0, 2.0, 2.0, 3.3,  # 1.0, 1.0, 1.3: spread 30%
                  3.3, 4.3, 4.3, 5.3, 5.3, 6.3])
    times, out = bench.timed_runs(lambda: "outs", clock=lambda: next(ticks))
    assert len(times) == 6 and out == "outs"
    ticks = iter([0.0, 1.0, 1.0, 2.0, 2.0, 3.05])
    times, _ = bench.timed_runs(lambda: None, clock=lambda: next(ticks))
    assert len(times) == 3 and bench.spread(times) <= bench.MAX_SPREAD


def _small_workload(h, w, k):
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend

    fe = load_learned_frontend(FLAGSHIP_PATH, (h, w), k, device="cpu", superglue_overrides={"gnn_layers": 2})
    wl = bench.prepare_workload("sp", "cpu", n_frames=5, n_unique=3, height=h, width=w, fe=fe, frame_chunk=4,
                                pair_chunk=3)
    times, outs = bench.timed_runs(wl.run, n=1)
    return wl, bench.workload_record(outs, wl.truth, times, wl.frontend)


def test_small_learned_workload_record():
    """224x160, K=256, two GNN layer pairs: the learned path passes its
    sanity check and tracks the clip; the record has bench.py's names."""
    wl, rec = _small_workload(160, 224, 256)
    assert wl.truth.shape == (5, 4, 4) and wl.sanity_matches >= bench.SANITY_MIN_MATCHES
    assert set(rec) - {"rpe"} <= _emitted_names()
    assert rec["frontend"] == "superpoint_superglue" and rec["n_frames"] == 4 and rec["ok_frames"] == 4
    assert rec["ate_rmse"] < 0.05 and rec["unit"] == "pairs/s" and set(rec["rpe"]) == {"delta_m", "rmse_pct",
                                                                                          "mean_pct", "n"}
    json.dumps(rec)


def test_learned_workload_falls_back_to_orb():
    """At 128x96 with K=64 the checkpoint finds fewer than 50 matches on two
    adjacent frames: the workload runs ORB and its record says so."""
    wl, rec = _small_workload(96, 128, 64)
    assert wl.sanity_matches < bench.SANITY_MIN_MATCHES
    assert wl.frontend == rec["frontend"] == "orb"

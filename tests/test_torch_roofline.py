"""The port's roofline (forest_slam_tpu_torch/utils/roofline.py) against the
JAX package's and against what the plain path computes and moves.

- ``roofline_summary`` equals the JAX function on the same chunk costs and
  counts, the JAX side on a stub device of a known TPU kind whose peaks the
  port is handed; no peaks give null shares.
- The products of the FLOP formula equal ``FlopCounterMode``'s count of the
  plain CPU path exactly: SuperPoint's network and extraction at 96x128
  (stems 1, 2 and 4, one octave and two), SuperGlue with 2 layers at K=64.
- The GNN, Sinkhorn and sparse-SAD FLOPs equal the JAX module's
  ``pallas_manual_costs`` formulas at the same shapes (its TPU check
  patched to true here).
- The byte count of a frame chunk and a pair chunk is at most the bytes of
  every aten op's inputs and outputs over the same plain run (a
  ``TorchDispatchMode``), for the learned front end and ORB.
- The layer weights' byte formula is the size of the kernel's weight tuple;
  ``device_peaks`` knows the H100s by name and nothing else.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

import forest_slam_tpu.utils as jutils
from forest_slam_tpu.frontend.learned import LearnedFrontendConfig as JaxLearnedConfig
from forest_slam_tpu.frontend.superglue import SuperGlueConfig as JaxSuperGlueConfig
from forest_slam_tpu.frontend.superpoint import SuperPointConfig as JaxSuperPointConfig
from forest_slam_tpu.pipelines.stereo import StereoConfig as JaxStereoConfig
from forest_slam_tpu.stereo.sparse import SparseStereoConfig as JaxSparseConfig
from forest_slam_tpu.utils import roofline as jroof
from forest_slam_tpu_torch import bench
from forest_slam_tpu_torch.frontend.base import learned_frontend, orb_frontend
from forest_slam_tpu_torch.frontend.gnn_kernel import split_layer_params
from forest_slam_tpu_torch.frontend.learned import LearnedFrontend, LearnedFrontendConfig
from forest_slam_tpu_torch.frontend.superglue import GnnLayer, SuperGlue, SuperGlueConfig
from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig, SuperPointNet
from forest_slam_tpu_torch.io.synthetic import corridor_trajectory, default_rig, make_corridor_world, render_stereo
from forest_slam_tpu_torch.pipelines.stereo import _map, frame_features, pair_from_slab
from forest_slam_tpu_torch.utils import roofline
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n_frames, fc, pc, elapsed", [(963, 32, 48, 1.75), (24, 32, 48, 0.5), (97, 8, 5, 3.2),
                                                       (10, 3, 3, 0.01)])
def test_roofline_summary_matches_jax(n_frames, fc, pc, elapsed):
    stub = SimpleNamespace(device_kind="TPU v5 lite")
    peaks = jroof.device_peaks(stub)
    assert peaks == (197e12, 819e9)
    ex, pr = (8.1e11, 1.79e8), (4.15e12, 1.9e8)
    ours = roofline.roofline_summary({"extract_chunk": roofline.StageCost(*ex), "pair_chunk": roofline.StageCost(*pr)},
                                     n_frames, fc, pc, elapsed, peaks)
    theirs = jroof.roofline_summary({"extract_chunk": jroof.StageCost(*ex), "pair_chunk": jroof.StageCost(*pr)},
                                    n_frames, fc, pc, elapsed, device=stub)
    assert ours == theirs
    blind = roofline.roofline_summary({"extract_chunk": roofline.StageCost(*ex),
                                       "pair_chunk": roofline.StageCost(*pr)}, n_frames, fc, pc, elapsed, None)
    assert blind["total_flops"] == theirs["total_flops"] and blind["total_bytes"] == theirs["total_bytes"]
    assert all(blind[k] is None for k in ("mfu", "hbm_frac", "roofline_frac", "peak_flops", "peak_bw"))


def test_device_peaks_by_name(monkeypatch):
    assert roofline.device_peaks("cpu") is None
    for name, peaks in (("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)), ("NVIDIA H100 PCIe", (756e12, 2.0e12)),
                        ("NVIDIA H100 NVL", (835e12, 3.9e12)), ("Tesla T4", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None, n=name: n)
        assert roofline.device_peaks("cuda") == peaks


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("stem", [1, 2, 4])
def test_superpoint_flops_match_flop_counter(stem):
    torch.manual_seed(0)
    sp = SuperPointConfig(stem_stride=stem, max_keypoints=64)
    net = SuperPointNet(sp)
    images = torch.rand(2, 96, 128) * 255
    assert _counted(lambda: net(images / 255.0)) == 2 * roofline.superpoint_flops(sp, 96, 128)
    for scales in ((1.0,), (1.0, 0.707)):
        cfg = LearnedFrontendConfig(superpoint=sp, superglue=SuperGlueConfig(gnn_layers=2), scales=scales)
        fe = LearnedFrontend(cfg, net, SuperGlue(cfg.superglue))
        expect = sum(roofline.superpoint_flops(sp, h, w) for h, w in roofline.octave_shapes(96, 128, scales, 8 * stem))
        assert _counted(lambda: fe.extract(images)) == 2 * expect


def test_superglue_matrix_flops_match_flop_counter():
    torch.manual_seed(0)
    cfg = SuperGlueConfig(gnn_layers=2)
    sg = SuperGlue(cfg)
    B, K = 2, 64
    args = []
    for _ in range(2):
        xy = torch.rand(B, K, 2) * torch.tensor([128.0, 96.0])
        desc = torch.nn.functional.normalize(torch.randn(B, K, 256), dim=-1)
        args += [xy, torch.rand(B, K), desc, torch.rand(B, K) < 0.9]
    with torch.no_grad():
        assert _counted(lambda: sg(*args, (96, 128))) == B * roofline.superglue_matrix_flops(cfg, K)


def _jax_frontend(fe_cfg):
    """A stand-in for the JAX FrontendFns whose extract closes over a
    LearnedFrontend (what pallas_manual_costs looks for)."""
    fe = SimpleNamespace(cfg=fe_cfg, superglue=None)

    def extract(*_):
        return fe

    return SimpleNamespace(name="superpoint_superglue", extract=extract)


@pytest.mark.parametrize("K, layers, iters", [(1024, 9, 20), (512, 2, 10)])
def test_kernel_flops_match_jax_manual_costs(monkeypatch, K, layers, iters):
    monkeypatch.setattr(jutils, "tpu_backend", lambda: True)
    H, W, pc, fc = 600, 960, 48, 32  # W % 128 != 0: no selection term on the JAX side

    def manual(gnn, attention, sinkhorn, cost_path="pallas"):
        sg = JaxSuperGlueConfig(gnn_layers=layers, sinkhorn_iterations=iters, gnn_impl=gnn, attention_impl=attention,
                                sinkhorn_impl=sinkhorn)
        fe_cfg = JaxLearnedConfig(superpoint=JaxSuperPointConfig(max_keypoints=K), superglue=sg)
        cfg = JaxStereoConfig(sparse=JaxSparseConfig(cost_path=cost_path), match_refine_radius=0)
        return jroof.pallas_manual_costs((H, W), cfg, _jax_frontend(fe_cfg), fc, pc)

    gnn = manual("fused", "xla", "xla")
    sinkhorn = manual("xla", "xla", "pallas")
    assert manual("xla", "xla", "xla")["pair_manual"].flops == 0
    cfg = SuperGlueConfig(gnn_layers=layers, sinkhorn_iterations=iters)
    assert gnn["pair_manual"].flops == pc * 4 * layers * roofline.gnn_apply_flops(K, K, 256, cfg.num_heads)
    assert sinkhorn["pair_manual"].flops == pc * roofline.sinkhorn_flops(K, K, iters)
    sparse = bench.main_config("sp").sparse
    assert gnn["extract_manual"].flops == roofline.sparse_sad_flops(K, sparse.num_disparities, sparse.window)
    assert manual("xla", "xla", "xla", cost_path="gather")["extract_manual"].flops == 0
    # a learned pair's FLOPs hold those GNN and Sinkhorn terms whole, beside the encoder, projection and scores
    others = roofline.superglue_matrix_flops(cfg, K) - 4 * layers * roofline.gnn_apply_matrix_flops(K, K, 256)
    assert roofline.superglue_flops(cfg, K) * pc == others * pc + gnn["pair_manual"].flops + sinkhorn["pair_manual"].flops


def test_gnn_weight_bytes_are_the_kernel_tuple():
    layer = GnnLayer(SuperGlueConfig())
    ws = split_layer_params(layer.flax_params(), 4)
    assert roofline.gnn_layer_weight_bytes(256) == sum(t.numel() * t.element_size() for t in ws)
    assert set(roofline._KERNELS) == {"sparse_cost", "gnn_layer", "sinkhorn_decode", "refine_cost", "detect",
                                      "select", "attention"}


class _Bytes(TorchDispatchMode):
    """Bytes of every aten op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.total += t.numel() * t.element_size()
        return out


def _frames(n, h, w):
    rig = default_rig(h, w, baseline=0.25, device="cpu")
    world = make_corridor_world(seed=0, device="cpu")
    il, ir, _ = render_stereo(world, corridor_trajectory(n, speed=0.15, device="cpu"), rig, h, w)
    return il.contiguous(), ir.contiguous(), rig


@pytest.mark.parametrize("frontend", ["sp", "orb"])
def test_byte_floor_below_the_plain_runs_traffic(frontend):
    """One frame chunk of 3 frames and one pair chunk of 2 pairs at
    96x128 (learned: stem 4, K=64, 2 layers; ORB: 128 features, 4 levels,
    refine radius 4): the formula's bytes at most what the ops touch."""
    torch.manual_seed(0)
    h, w, fc, pc = 96, 128, 3, 2
    il, ir, rig = _frames(fc, h, w)
    if frontend == "sp":
        fe_cfg = LearnedFrontendConfig(superpoint=SuperPointConfig(stem_stride=4, max_keypoints=64),
                                       superglue=SuperGlueConfig(gnn_layers=2))
        fns = learned_frontend(LearnedFrontend(fe_cfg, SuperPointNet(fe_cfg.superpoint), SuperGlue(fe_cfg.superglue)))
        cfg = bench.main_config("sp", n_kpts=64, n_hypotheses=64)
    else:
        fe_cfg = None
        cfg = bench.main_config("orb", n_kpts=128, orb_levels=4, n_hypotheses=64, refine_radius=4)
        fns = orb_frontend(cfg.orb, cfg.max_match_distance)
    costs = roofline.stereo_pipeline_costs((h, w), cfg, fe_cfg, fc, pc)
    with torch.no_grad():
        with _Bytes() as ex:
            feats, z, z_ok = frame_features(il, ir, rig, cfg, fns)
        g = torch.Generator()
        g.manual_seed(0)
        prev, cur = _map(lambda a: a[:pc], feats), _map(lambda a: a[1:], feats)
        with _Bytes() as pr:
            pair_from_slab(prev, z[:pc], z_ok[:pc], cur, rig, cfg, fns, (h, w), il[:pc], il[1:], generator=g)
    assert 0 < costs["extract_chunk"].bytes <= ex.total
    assert 0 < costs["pair_chunk"].bytes <= pr.total
    assert costs["extract_chunk"].flops > 0 and costs["pair_chunk"].flops > 0


def test_bench_path_shares_stay_below_one():
    """The 962-pair workloads' counts (learned: the flagship's stem 4 and
    9 layers; ORB) at the mean chunk sizes: the totals are the run's frames
    and pairs plus one weight read a chunk, and their shares of the H100's
    peaks at median times of 1.688 s and 1.067 s (learned, ORB) are far below 1."""
    peaks = roofline.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]
    fe_cfg = LearnedFrontendConfig(superpoint=SuperPointConfig(stem_stride=4), superglue=SuperGlueConfig())
    n = bench.N_FRAMES
    n_fc, n_pc = -(-n // 32), -(-(n - 1) // 48)
    for cfg, fcfg, elapsed in ((bench.main_config("sp"), fe_cfg, 1.688), (bench.main_config("orb"), None, 1.067)):
        costs = roofline.stereo_pipeline_costs((600, 960), cfg, fcfg, n / n_fc, (n - 1) / n_pc)
        one, none = (roofline.stereo_pipeline_costs((600, 960), cfg, fcfg, c, c) for c in (1, 0))
        s = roofline.roofline_summary(costs, n, 32, 48, elapsed, peaks)
        for i, total in enumerate(("total_flops", "total_bytes")):
            ex, pr = (one[k][i] - none[k][i] for k in ("extract_chunk", "pair_chunk"))
            expect = n * ex + (n - 1) * pr + n_fc * none["extract_chunk"][i] + n_pc * none["pair_chunk"][i]
            np.testing.assert_allclose(s[total], expect, rtol=1e-12)
        assert 0 < s["mfu"] < 0.5 and 0 < s["hbm_frac"] < 0.5 and s["roofline_frac"] == max(s["mfu"], s["hbm_frac"])

"""Kernels of the port against their plain versions on a CUDA card.

Marked ``cuda``: each test decides in the ``cuda`` fixture whether a card is
present and skips with a reason where there is none (the CPU run). On the
card: ``python -m pytest tests/test_torch_cuda.py -m cuda``. Tolerances as in
chip_smoke.py: integer-valued images make the SAD kernels exact (the sparse
cost on float frames within rtol 1e-6, atol 1e-4: summation order); the GNN
layer's bf16 outputs may differ by roundings; Sinkhorn scores to 1e-4 and
argmax agreement 0.999 (at iters 0, 1 and 20 and every cluster size); the
detection kernel keeps the same finite mask, values to rtol 1e-5 and equal
indices (it sums Harris in the plain version's order, so it is exact), one
level a call or every level of a batch in one launch; the
select kernel only compares, so it is bit-exact; the attention kernel's bf16
output within 2^-7 of its largest entry, mean 1e-3, as
tests/test_torch_attention.py holds the plain version to the reference; its
gradients under autograd (a recompute of the plain version) equal the plain
version's autograd bit for bit. One training step of the full-width recipe
on the card agrees with the CPU's within chip_smoke.TRAIN_AGREEMENT, one
distillation step of the round-5 recipe within
chip_smoke.DISTILL_AGREEMENT; the SGM disparity (plain PyTorch) on the card
equals the CPU's on the OpenCV fixture. The back end (``-k slam``): the pose
graph, batched BA and window BA on the card within 1e-4 of the CPU, loop
verification's batch with the same draws and the learned matcher's batch
against the CPU's plain versions, streaming equal to the scan. The bag
loader (``-k bag``): frames undistorted onto the card within 1e-3 grey
levels of the CPU's. The bench's routes (``-k "flash or pallas_equals"``):
``--sg-attention flash`` (``scaled_dot_product_attention``) against the
dense path and the plain version, and ``--refine-cost-path pallas`` equal to
``xla``. Multi-GPU on one card (``-k multichip``): a one-rank NCCL mesh's
sharded train step against ``train_step`` within
chip_smoke.TRAIN_AGREEMENT and tests/test_training.py's 5% on the update
norm, and ``run_batched_eval`` equal to ``run_stereo_vo_device`` on each
sequence bit for bit. PnP-RANSAC's refine-and-select kernel (``-k pnp``)
against its plain version: the candidate it picks the plain version's or
within 1e-3 in score, R and t to 1e-4, inlier counts within 2 and masks
within 0.5% (summation order moves points at the gate), at 1 to 192 pairs,
DLT-6 and P3P, and with 256 hypotheses under BotanicGarden's distortion on
six seeds, where only pairs chip_smoke.pnp_degenerate marks may differ (at
most 5% of a call's pairs, counted); solve_pnp_ransac with its draws
handed in syncs nothing. LightGlue (``-k lightglue``): the fused layer's
rotary and GELU variants against their plain versions, and the whole
matcher's scores against the benchmark's plain reference, at the
``sp_lightglue.seq962`` cell's shape (48 pairs of 2048 keypoints) with
full-strength weights, each tolerance beside a control in fp8 that fails
it; the matcher syncs nothing; SuperGlue's layer gives the bits it gave
before the variants existed; a device recording credits the fused layer's
kernels to the self and cross spans that launched them.
"""

import hashlib

import pytest
import torch

from forest_slam_tpu_torch.frontend.attention_kernel import attention_forward, masked_attention, masked_attention_plain
from forest_slam_tpu_torch.frontend import detect_kernel
from forest_slam_tpu_torch.frontend.detect_kernel import detect_pooled, detect_pooled_levels, detect_pooled_plain
from forest_slam_tpu_torch.frontend.gnn_kernel import gnn_layer, gnn_layer_plain, split_layer_params
from forest_slam_tpu_torch.frontend.refine_kernel import (
    keypoints_per_block,
    refine_cost_volume,
    refine_cost_volume_plain,
)
from forest_slam_tpu_torch.frontend.select_kernel import BAND_ROWS, BLOCK, nms_block_max, nms_block_max_plain
from forest_slam_tpu_torch.frontend.select_kernel import launch_plan as launch_select
from forest_slam_tpu_torch.frontend.orb import OrbConfig, _level_geometry
from forest_slam_tpu_torch.frontend.sinkhorn_kernel import _launch, launch_plan, sinkhorn_decode, sinkhorn_decode_plain
from forest_slam_tpu_torch.stereo.sparse import prefilter
from forest_slam_tpu_torch.stereo.sparse_kernel import launch_plan as launch_sparse
from forest_slam_tpu_torch.stereo.sparse_kernel import sparse_cost_rows, sparse_cost_rows_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return torch.device("cuda"), g


def _sparse_inputs(g, dev, B, H, W, K, integer=True):
    """Prefiltered frames, integer-valued or not, and keypoints that run
    past every edge, with the four corners and each border's midpoint."""
    imgs = torch.randint(0, 256, (2, B, H, W), generator=g, device=dev).float()
    if not integer:
        imgs = imgs + torch.rand((2, B, H, W), generator=g, device=dev)
    pl, pr = prefilter(imgs[0], 31.0).contiguous(), prefilter(imgs[1], 31.0).contiguous()
    xi = torch.randint(-5, W + 5, (B, K), generator=g, device=dev, dtype=torch.int32)
    yi = torch.randint(-5, H + 5, (B, K), generator=g, device=dev, dtype=torch.int32)
    edges = [(0, 0), (W - 1, 0), (0, H - 1), (W - 1, H - 1), (W // 2, 0), (W // 2, H - 1), (0, H // 2),
             (W - 1, H // 2), (-3, H + 2), (W + 4, -1)]
    for j, (x, y) in enumerate(edges[:K]):
        xi[:, j], yi[:, j] = x, y
    return pl, pr, xi, yi


# (D, w): the paths' (96, 7), the old card test's (48, 7), the smallest, two
# past the TPU kernel's limits (D + w - 1 > 128, w > 8) and an even window;
# B = 1 and 24; K never a multiple of the keypoints a block takes
@pytest.mark.parametrize("B", [1, 24])
@pytest.mark.parametrize("D, w", [(96, 7), (48, 7), (1, 1), (128, 9), (160, 15), (96, 6)])
def test_sparse_cost_kernel(cuda, D, w, B):
    """Integer-valued images: every SAD sum is exact, so tolerance 0. Width
    192 takes the kernel's 16-byte copies, 190 its 4-byte ones."""
    dev, g = cuda
    kp = launch_sparse(D, w)["keypoints_per_block"]
    K = 3 * kp + 5
    for W in (192, 190):
        args = (*_sparse_inputs(g, dev, B, 60, W, K), D, w)
        n = sparse_cost_rows.launches
        got = sparse_cost_rows(*args)
        assert sparse_cost_rows.launches == n + 1
        ref = sparse_cost_rows_plain(*args)
        assert (ref > 0).any()
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_sparse_cost_kernel_float_images(cuda):
    """Non-integer frames at the paths' (96, 7): the kernel sums each
    disparity's 49 taps in (dy, dx) order and the plain version in its
    reduction's order, so float32 roundings may differ; sums reach about
    1e4, hence rtol 1e-6 and atol 1e-4."""
    dev, g = cuda
    for W in (200, 201):
        args = (*_sparse_inputs(g, dev, 3, 120, W, 301, integer=False), 96, 7)
        torch.testing.assert_close(sparse_cost_rows(*args), sparse_cost_rows_plain(*args), rtol=1e-6, atol=1e-4)


def test_sparse_cost_kernel_refuses(cuda):
    dev, g = cuda
    pl, pr, xi, yi = _sparse_inputs(g, dev, 1, 40, 60, 9)
    n = sparse_cost_rows.launches
    with pytest.raises(ValueError, match="windows of 1..15"):
        sparse_cost_rows(pl, pr, xi, yi, 96, 17)
    with pytest.raises(ValueError, match="exceeds"):
        sparse_cost_rows(pl, pr, xi, yi, 4000, 15)
    assert sparse_cost_rows.launches == n


def test_refine_cost_kernel(cuda):
    dev, g = cuda
    imgs = torch.randint(0, 256, (2, 3, 100, 140), generator=g, device=dev).float()
    ri = lambda hi: torch.randint(0, hi, (3, 200), generator=g, device=dev, dtype=torch.int32)
    nvalid = torch.tensor([0, 77, 200], dtype=torch.int32, device=dev)
    args = (imgs[0].contiguous(), imgs[1].contiguous(), ri(140), ri(100), ri(140), ri(100), 8, 12, nvalid)
    torch.testing.assert_close(refine_cost_volume(*args), refine_cost_volume_plain(*args), rtol=0, atol=0)


# (template, radius): the paths' (8, 12), a small and a large radius, an
# odd n not a multiple of the kernel's 5-wide strips
@pytest.mark.parametrize("t, R", [(8, 12), (8, 2), (4, 16), (6, 5)])
def test_refine_cost_kernel_shapes(cuda, t, R):
    """Every (t, R) above, nvalid 0, partial and full, B * K not a multiple of
    the keypoints a block takes, and keypoints on the image border."""
    dev, g = cuda
    kp = keypoints_per_block(t, R)
    H, W, K = 90, 130, 4 * kp + 6
    B = next(b for b in (3, 5, 7) if (b * K) % kp)
    imgs = torch.randint(0, 256, (2, B, H, W), generator=g, device=dev).float()
    ri = lambda hi: torch.randint(0, hi, (B, K), generator=g, device=dev, dtype=torch.int32)
    xi0, yi0, xi1, yi1 = ri(W), ri(H), ri(W), ri(H)
    border = torch.tensor([[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0], [1, 2]], device=dev, dtype=torch.int32)
    for x, y in ((xi0, yi0), (xi1, yi1)):
        x[:, :5], y[:, :5] = border[:, 0], border[:, 1]
        x[:, -5:], y[:, -5:] = border.flip(0)[:, 0], border.flip(0)[:, 1]
    nvalid = torch.tensor([0, K // 2 + 1, K, 1, K - 1, 2, K][:B], dtype=torch.int32, device=dev)
    args = (imgs[0].contiguous(), imgs[1].contiguous(), xi0, yi0, xi1, yi1, t, R, nvalid)
    n = refine_cost_volume.launches
    got = refine_cost_volume(*args)
    assert refine_cost_volume.launches == n + 1
    torch.testing.assert_close(got, refine_cost_volume_plain(*args), rtol=0, atol=0)
    assert (got[0] == 0).all() and (got[1, K // 2 + 1:] == 0).all() and (got[2] > 0).any()


def _sinkhorn_inputs(g, dev, B, K0, K1, dead_pair, eye=6.0):
    s = (torch.randn((B, K0, K1), generator=g, device=dev) * 1.5 + eye * torch.eye(K0, K1, device=dev)).contiguous()
    v0 = torch.rand((B, K0), generator=g, device=dev) < 0.8
    v1 = torch.rand((B, K1), generator=g, device=dev) < 0.8
    if dead_pair:
        v0[1] = False  # a pair whose keypoints on one side are all invalid
    return s, v0, v1, torch.tensor(1.3, device=dev)


def _check_sinkhorn(got, ref):
    assert all(torch.isfinite(t.float()).all() for t in got)
    assert (got[0] == ref[0]).float().mean() >= 0.999 and (got[2] == ref[2]).float().mean() >= 0.999
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[3], ref[3], rtol=0, atol=1e-4)


# (B, K0, K1, dead_pair[, eye]): ragged K0 != K1 not a multiple of 4 with a
# pair whose valid0 is all False, one row, the lowres gate's and the learned
# paths' shapes, all with a matching diagonal raised by 6; and flat random
# scores (eye 0), whose near-ties put the argmax agreement to the test;
# iters 0 decodes from A = V = 1
@pytest.mark.parametrize("iters", [0, 1, 20])
@pytest.mark.parametrize("shape", [(3, 200, 170, True), (2, 1, 37, False), (23, 512, 512, False),
                                   (8, 1024, 1024, False), (3, 200, 170, False, 0.0)])
def test_sinkhorn_kernel(cuda, shape, iters):
    dev, g = cuda
    s, v0, v1, alpha = _sinkhorn_inputs(g, dev, *shape)
    n = sinkhorn_decode.launches
    got = sinkhorn_decode(s, v0, v1, alpha, iters)
    assert sinkhorn_decode.launches == n + 1
    _check_sinkhorn(got, sinkhorn_decode_plain(s, v0, v1, alpha, iters))


@pytest.mark.parametrize("cluster", [1, 2, 3, 8, 16])
def test_sinkhorn_kernel_cluster_sizes(cuda, cluster):
    """Every cluster size gives the same answer: the exchange through
    distributed shared memory at 2..16 CTAs a pair, rows that lie in the L2
    scratch (one CTA a pair holds 1024 rows of 4 KB only in part) and rows
    wider than 1024 (a row sweep, then a column sweep)."""
    dev, g = cuda
    for shape in ((3, 200, 170, True), (2, 1024, 1024, False), (2, 96, 1300, False)):
        s, v0, v1, alpha = _sinkhorn_inputs(g, dev, *shape)
        plan = launch_plan(*shape[:3], dev, cluster)
        assert plan["cluster"] == cluster and plan["rows_per_cta"] == -(-shape[1] // cluster)
        _check_sinkhorn(_launch(s, v0, v1, alpha, 20, cluster), sinkhorn_decode_plain(s, v0, v1, alpha, 20))
    assert launch_plan(2, 1024, 1024, dev, 1)["l2_rows"] > 0


def test_sinkhorn_kernel_rejects_what_it_does_not_take(cuda):
    dev, _ = cuda
    s = torch.zeros((1, 4, 60000), device=dev)
    v0, v1 = torch.ones((1, 4), dtype=torch.bool, device=dev), torch.ones((1, 60000), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="too wide"):
        sinkhorn_decode(s, v0, v1, 1.0, 20)
    with pytest.raises(ValueError, match="iters"):
        sinkhorn_decode(s[:, :, :8].contiguous(), v0, v1[:, :8], 1.0, -1)
    with pytest.raises(ValueError, match="contiguous"):
        sinkhorn_decode(s[:, :, ::2], v0, v1[:, ::2], 1.0, 20)


@pytest.mark.parametrize("N, K, S, all_masked", [(4, 150, 130, False), (4, 150, 130, True), (48, 512, 512, False)])
def test_gnn_layer_kernel(cuda, N, K, S, all_masked):
    """Ragged K != S, a sequence whose sources are all masked, and the lowres
    gate's shape (48 sequences of 512 x 256)."""
    import numpy as np

    dev, g = cuda
    rng = np.random.default_rng(0)
    D = 256
    lp = {
        "attn": {n: {"kernel": rng.normal(size=(D, D)) * 0.06, "bias": rng.normal(size=D) * 0.1}
                 for n in ("q", "k", "v", "merge")},
        "mlp0": {"kernel": rng.normal(size=(2 * D, 2 * D)) * 0.04, "bias": rng.normal(size=2 * D) * 0.1},
        "ln": {"scale": 1 + rng.normal(size=2 * D) * 0.1, "bias": rng.normal(size=2 * D) * 0.1},
        "mlp1": {"kernel": rng.normal(size=(2 * D, D)) * 0.04, "bias": rng.normal(size=D) * 0.1},
    }
    ws = split_layer_params(lp, 4, device=dev)
    x = torch.randn((N, K, D), generator=g, device=dev).to(torch.bfloat16)
    src = torch.randn((N, S, D), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.rand((N, S), generator=g, device=dev) < 0.7
    if all_masked:
        mask[-1] = False
    n = gnn_layer.launches
    got = gnn_layer(x, src, mask, ws, 4).float()
    assert gnn_layer.launches == n + 1
    ref = gnn_layer_plain(x, src, mask, ws, 4).float()
    assert torch.isfinite(got).all()
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= 0.05 * scale
    assert (got - ref).abs().mean().item() <= 2e-3 * scale


def _check_detect(imgs, **kw):
    n = detect_pooled.launches
    vals, idx = detect_pooled(imgs, **kw)
    assert detect_pooled.launches == n + 1
    ref_v, ref_i = detect_pooled_plain(imgs, **kw)
    fin = torch.isfinite(ref_v)
    assert torch.equal(torch.isfinite(vals), fin)
    torch.testing.assert_close(vals[fin], ref_v[fin], rtol=1e-5, atol=0)
    assert torch.equal(idx, ref_i)  # empty cells too: their top-left pixel
    return int(fin.sum())


def test_detect_kernel_ragged_batched(cuda):
    dev, g = cuda
    for B, H, W in ((3, 83, 157), (2, 45, 70), (1, 33, 41)):
        imgs = (torch.rand((B, H, W), generator=g, device=dev) * 255).contiguous()
        assert _check_detect(imgs) > 0
    blocks = torch.randint(0, 256, (2, 12, 20), generator=g, device=dev).float()
    blocky = blocks.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :90, :150].contiguous()
    assert _check_detect(blocky, margin=4) > 0  # equal responses: the tie rule


def test_detect_kernel_empty_cells(cuda):
    dev, _ = cuda
    assert _check_detect(torch.full((2, 61, 77), 9.0, device=dev)) == 0


def test_detect_kernel_pyramid_shapes(cuda):
    dev, g = cuda
    sizes, _ = _level_geometry(600, 960, OrbConfig())
    for h, w, _ in sizes:
        imgs = (torch.rand((8, h, w), generator=g, device=dev) * 255).contiguous()
        assert _check_detect(imgs) > 100


def _check_levels(levels, **kw):
    """All levels in one launch against the plain version level by level."""
    n = detect_pooled.launches
    got = detect_pooled_levels(levels, **kw)
    assert detect_pooled.launches == n + 1
    finite = 0
    for lv, (vals, idx) in zip(levels, got):
        ref_v, ref_i = detect_pooled_plain(lv, **kw)
        fin = torch.isfinite(ref_v)
        assert torch.equal(torch.isfinite(vals), fin)
        torch.testing.assert_close(vals[fin], ref_v[fin], rtol=1e-5, atol=0)
        assert torch.equal(idx, ref_i)
        finite += int(fin.sum())
    return finite


def test_detect_levels_kernel_pyramid_shapes(cuda):
    """The eight 960x600 pyramid levels of 8 frames in one launch."""
    dev, g = cuda
    sizes, _ = _level_geometry(600, 960, OrbConfig())
    levels = [(torch.rand((8, h, w), generator=g, device=dev) * 255).contiguous() for h, w, _ in sizes]
    assert _check_levels(levels) > 8 * 100


@pytest.mark.parametrize("threshold", [20.0, 0.0])
def test_detect_levels_kernel_exact_threshold(cuda, threshold):
    """Integer images whose ring differences hit +-threshold exactly."""
    dev, g = cuda
    levels = [(torch.randint(0, 4, (2, 70, 90), generator=g, device=dev) * 20).float(),
              torch.randint(0, 60, (2, 61, 77), generator=g, device=dev).float(),
              (torch.randint(0, 12, (2, 45, 50), generator=g, device=dev) * 5).float()]
    assert _check_levels(levels, threshold=threshold, margin=4) > 10


def test_detect_levels_kernel_ragged_tiny_empty_ties(cuda):
    dev, g = cuda
    levels = [(torch.rand((3, h, w), generator=g, device=dev) * 255).contiguous()
              for h, w in ((33, 41), (83, 157), (45, 70), (1, 1), (8, 9))]
    assert _check_levels(levels) > 0  # reordered largest first inside the launch
    flat = [torch.full((2, 61, 77), 9.0, device=dev), torch.full((2, 40, 33), 200.0, device=dev)]
    assert _check_levels(flat) == 0
    blocks = torch.randint(0, 256, (2, 12, 20), generator=g, device=dev).float()
    blocky = blocks.repeat_interleave(8, 1).repeat_interleave(8, 2)
    assert _check_levels([blocky[:, :90, :150].contiguous(), blocky[:, :41, :67].contiguous()], margin=4) > 0


def test_detect_levels_kernel_more_levels_than_a_launch_takes(cuda):
    """Past MAX_LEVELS levels the wrapper makes one launch per MAX_LEVELS."""
    dev, g = cuda
    sizes = [(40 + 3 * i, 33 + 5 * i) for i in range(detect_kernel.MAX_LEVELS + 2)]
    levels = [(torch.rand((2, h, w), generator=g, device=dev) * 255).contiguous() for h, w in sizes]
    n = detect_pooled.launches
    got = detect_pooled_levels(levels, margin=4)
    assert detect_pooled.launches == n + 2
    for lv, (vals, idx) in zip(levels, got):
        ref_v, ref_i = detect_pooled_plain(lv, margin=4)
        fin = torch.isfinite(ref_v)
        assert torch.equal(torch.isfinite(vals), fin)
        torch.testing.assert_close(vals[fin], ref_v[fin], rtol=1e-5, atol=0)
        assert torch.equal(idx, ref_i)


@pytest.mark.parametrize("block", [7, 5, 3, 1])
def test_detect_levels_kernel_harris_blocks(cuda, block):
    """Harris blocks 1-7 in one launch over ragged levels."""
    dev, g = cuda
    levels = [(torch.rand((2, h, w), generator=g, device=dev) * 255).contiguous()
              for h, w in ((130, 200), (97, 140), (33, 41))]
    assert _check_levels(levels, harris_block=block) > 0


def test_detect_kernel_rejects_what_it_does_not_take(cuda):
    dev, _ = cuda
    imgs = torch.zeros((1, 40, 40), device=dev)
    with pytest.raises(ValueError, match="harris_block"):
        detect_pooled(imgs, harris_block=9)
    with pytest.raises(ValueError, match="contiguous float32"):
        detect_pooled(imgs.double())
    with pytest.raises(ValueError, match="contiguous float32"):
        detect_pooled(torch.zeros((1, 40, 80), device=dev)[:, :, ::2])
    with pytest.raises(ValueError, match="one batch"):
        detect_pooled_levels([imgs, torch.zeros((2, 20, 20), device=dev)])


def _peaky_heat(g, dev, B, H, W):
    heat = torch.rand((B, H, W), generator=g, device=dev) * 0.004
    peaks = torch.rand((B, H, W), generator=g, device=dev)
    return torch.where(peaks > 0.99, peaks, heat).contiguous()


@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 100, 172), (1, 160, 224), (2, 600, 960)])
def test_select_kernel_bit_exact(cuda, shape):
    dev, g = cuda
    heat = _peaky_heat(g, dev, *shape)
    heat[0, :8, :8] = 0.9  # a peak run into the border and the image edge
    heat[-1, 40:44, 60:64] = 0.5  # equal survivors: the tie rule
    n = nms_block_max.launches
    vals, idx = nms_block_max(heat)
    assert nms_block_max.launches == n + 1
    ref_v, ref_i = nms_block_max_plain(heat)
    assert int((ref_v > 0).sum()) > 10
    assert torch.equal(vals, ref_v) and torch.equal(idx, ref_i)


def test_select_kernel_negative_heat_and_radius(cuda):
    """Out-of-image pixels never win a window maximum, whatever the sign of
    the heat; other NMS radii."""
    dev, g = cuda
    heat = (torch.rand((2, 48, 80), generator=g, device=dev) - 0.5).contiguous()
    for r in (0, 3, 8):
        got = nms_block_max(heat, nms_radius=r, threshold=-1.0)
        ref = nms_block_max_plain(heat, nms_radius=r, threshold=-1.0)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="radius"):
        nms_block_max(heat, nms_radius=9)
    with pytest.raises(ValueError, match="multiples of 4"):
        nms_block_max(heat[:, :46].contiguous())


def _plant_select_cases(heat, r):
    """Equal survivors inside a block and on both sides of a warp's edge
    column, a peak suppressed across that edge, and pairs of peaks within r
    of a band's top and bottom rows (one suppresses the other only if the
    band's halo rows are read)."""
    B, H, W = heat.shape
    edge = BLOCK * launch_select(heat.shape, r)["lanes"]  # first column of the second warp
    band = BAND_ROWS
    for b in range(B):
        if H >= 12 and W >= 16:
            heat[b, 8, 8] = heat[b, 9, 10] = 0.7  # one block, equal
        if H >= 12 and W >= edge + 8:
            heat[b, 6, edge - 1] = heat[b, 6, edge] = 0.75  # two blocks across the edge, equal
            heat[b, 10, edge - 2] = 0.6
            heat[b, 10, edge - 2 + max(r, 1)] = 0.65
        if H >= band + r + 2 and W >= 40:
            heat[b, band - 1, 20] = 0.8
            heat[b, band - 1 + max(r, 1), 21] = 0.85  # below the band's last row
            heat[b, band + 1, 30] = 0.9
            heat[b, band + 1 - max(r, 1), 29] = 0.88  # above the next band's first row
    return heat.contiguous()


# widths that are multiples of 4 but not of a warp's 112 or 120 columns,
# heights of 4 and 8 and not a multiple of the 8-row band, B = 1 and 24
@pytest.mark.parametrize("shape", [(1, 4, 4), (24, 8, 36), (1, 36, 124), (2, 52, 132), (24, 160, 224)])
@pytest.mark.parametrize("r", range(9))
def test_select_kernel_radii_and_shapes(cuda, r, shape):
    dev, g = cuda
    heat = _plant_select_cases(_peaky_heat(g, dev, *shape), r)
    n = nms_block_max.launches
    vals, idx = nms_block_max(heat, nms_radius=r)
    assert nms_block_max.launches == n + 1
    ref_v, ref_i = nms_block_max_plain(heat, nms_radius=r)
    assert torch.equal(vals, ref_v) and torch.equal(idx, ref_i)
    neg = (torch.rand(shape, generator=g, device=dev) - 0.5).contiguous()
    got = nms_block_max(neg, nms_radius=r, threshold=-1.0, border=0)
    ref = nms_block_max_plain(neg, nms_radius=r, threshold=-1.0, border=0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# (B, h, K, S): S below 16, one query, S not a multiple of the kernel's
# 64-source tile, K != S both ways, and the unfused path's shape
@pytest.mark.parametrize("shape", [(2, 4, 128, 128), (3, 4, 100, 77), (16, 4, 1024, 1024), (2, 4, 70, 9),
                                   (3, 2, 1, 77), (2, 4, 200, 200), (3, 4, 150, 130), (2, 4, 40, 330)])
def test_attention_kernel(cuda, shape):
    dev, g = cuda
    B, h, K, S = shape
    dh = 64
    q = (torch.randn((B, h, K, dh), generator=g, device=dev) * 2).to(torch.bfloat16)
    k = (torch.randn((B, h, S, dh), generator=g, device=dev) * 2).to(torch.bfloat16)
    v = torch.randn((B, h, S, dh), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.rand((B, S), generator=g, device=dev) < 0.7
    mask[-1] = False  # a batch whose sources are all masked
    n = attention_forward.launches
    got = attention_forward(q, k, v, mask, 0.125).float()
    assert attention_forward.launches == n + 1
    ref = masked_attention_plain(q, k, v, mask, 0.125).float()
    assert torch.isfinite(got).all()
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 2.0 ** -7 * scale
    assert (got - ref).abs().mean().item() <= 1e-3 * max(scale, 1.0)


def test_attention_function_gradients(cuda):
    dev, g = cuda
    B, h, K, dh = 2, 4, 128, 64
    ts = [(torch.randn((B, h, K, dh), generator=g, device=dev) * s).to(torch.bfloat16).requires_grad_()
          for s in (2.0, 2.0, 1.0)]
    mask = torch.rand((B, K), generator=g, device=dev) < 0.7
    gout = torch.randn((B, h, K, dh), generator=g, device=dev)
    n = attention_forward.launches
    (masked_attention(*ts, mask, 0.125).float() * gout).sum().backward()
    assert attention_forward.launches == n + 1
    refs = [t.detach().clone().requires_grad_() for t in ts]
    (masked_attention_plain(*refs, mask, 0.125).float() * gout).sum().backward()
    for t, r in zip(ts, refs):
        # the backward is the same recompute on both sides: only the
        # forward's kernel differs, and it enters no gradient
        assert torch.equal(t.grad, r.grad)
    with pytest.raises(ValueError, match="64-wide"):
        attention_forward(*(torch.zeros((1, 2, 8, 32), dtype=torch.bfloat16, device=dev),) * 3,
                          torch.ones((1, 8), dtype=torch.bool, device=dev), 0.125)


# the shapes bench.py's workload and gates add (forest_slam_tpu_torch/bench.py)


def _tied_heat(B, H, W, step=8):
    """tests/test_torch_select.py's tied heat (that file imports jax; this
    one runs where jax is not installed): equal 0.5 peaks on a grid, a few
    0.7 peaks, a floor under the threshold."""
    heat = torch.full((B, H, W), 0.001)
    heat[:, 4:H - 4:step, 4:W - 4:step] = 0.5
    heat[:, 12:H - 4:3 * step, 20:W - 4:5 * step] = 0.7
    return heat


@pytest.mark.parametrize("shape, K", [((2, 64, 128), 64), ((1, 62, 128), 40), ((4, 600, 960), 1024)])
def test_select_keypoints_tie_order_card_equals_cpu(cuda, shape, K):
    """Tied heat across blocks and across the K-th slot: the keypoints the
    card keeps, in slot order, are the CPU path's (which
    tests/test_torch_select.py holds to the JAX order); the block path
    launches the select kernel, the dense path (62 rows) takes the top-k
    alone."""
    from forest_slam_tpu_torch.frontend.superpoint import SuperPointConfig, block_path, select_keypoints

    dev, g = cuda
    B, H, W = shape
    heat = _tied_heat(B, H, W)
    coarse = torch.randn((B, H // 8, W // 8, 16), generator=torch.Generator().manual_seed(0))
    coarse = coarse / coarse.norm(dim=-1, keepdim=True)
    cfg = SuperPointConfig(max_keypoints=K, descriptor_dim=16, desc_sample_dtype=None)
    n = nms_block_max.launches
    got = select_keypoints(heat.to(dev), coarse.to(dev), cfg)
    assert nms_block_max.launches == n + int(block_path(cfg, H, W))
    ref = select_keypoints(heat, coarse, cfg)
    assert torch.equal(got.xy.cpu(), ref.xy) and torch.equal(got.score.cpu(), ref.score)
    assert torch.equal(got.valid.cpu(), ref.valid) and float(ref.score[0, -1]) == 0.5


# frame 0 upscaled by the wide-baseline refine scales 1.0, 1.2, 1.44, 1.7
# (960x600 -> 1152x720, 1382x864, 1632x1020) against frame 1 at 960x600
@pytest.mark.parametrize("H0, W0", [(600, 960), (720, 1152), (864, 1382), (1020, 1632)])
def test_refine_cost_kernel_radius_24_upscaled_frame0(cuda, H0, W0):
    dev, g = cuda
    t, R, B = 8, 24, 3
    kp = keypoints_per_block(t, R)
    K = 5 * kp + 2
    img0 = torch.randint(0, 256, (B, H0, W0), generator=g, device=dev).float()
    img1 = torch.randint(0, 256, (B, 600, 960), generator=g, device=dev).float()
    ri = lambda hi: torch.randint(0, hi, (B, K), generator=g, device=dev, dtype=torch.int32)
    xi1, yi1 = ri(960), ri(600)
    xi0 = (xi1.float() * W0 / 960).round().int().clamp(0, W0 - 1)
    yi0 = (yi1.float() * H0 / 600).round().int().clamp(0, H0 - 1)
    xi0[:, :2], yi0[:, :2] = torch.tensor([0, W0 - 1], device=dev, dtype=torch.int32), torch.tensor(
        [H0 - 1, 0], device=dev, dtype=torch.int32)
    nvalid = torch.tensor([K, K // 3, 0], dtype=torch.int32, device=dev)
    args = (img0, img1, xi0.contiguous(), yi0.contiguous(), xi1, yi1, t, R, nvalid)
    n = refine_cost_volume.launches
    got = refine_cost_volume(*args)
    assert refine_cost_volume.launches == n + 1 and got.shape == (B, K, 49, 49)
    torch.testing.assert_close(got, refine_cost_volume_plain(*args), rtol=0, atol=0)
    assert (got[2] == 0).all() and (got[0] > 0).any()


@pytest.mark.parametrize("shape", [(2, 416, 672), (2, 288, 480), (16, 416, 672)])
def test_select_kernel_wide_baseline_octaves(cuda, shape):
    """The octaves 0.707 and 0.5 of 960x600 at the flagship's stride 32, as
    resized heat hands them to the kernel (contiguous)."""
    from forest_slam_tpu_torch.utils.filters import resize_bilinear

    dev, g = cuda
    B, H, W = shape
    heat = resize_bilinear(_peaky_heat(g, dev, B, 600, 960), H, W).contiguous()
    n = nms_block_max.launches
    vals, idx = nms_block_max(heat)
    assert nms_block_max.launches == n + 1
    ref_v, ref_i = nms_block_max_plain(heat)
    assert int((ref_v > 0).sum()) > 10
    assert torch.equal(vals, ref_v) and torch.equal(idx, ref_i)


def test_p3p_ransac_card_equals_cpu(cuda):
    """P3P RANSAC with the same injected draws on the card and on the CPU.
    The card's float32 arithmetic rounds differently (fused multiply-adds,
    its own sqrt, atan2 and SVD), which can move an ill-conditioned
    hypothesis, so poses to 1e-3 and inlier counts within 3, both near the
    truth."""
    import numpy as np

    from forest_slam_tpu_torch.core.camera import PinholeCamera
    from forest_slam_tpu_torch.core.lie import se3_exp
    from forest_slam_tpu_torch.geometry.pnp import solve_pnp_ransac

    dev, _ = cuda
    rng = np.random.default_rng(1)
    Kmat = np.array([[643.2, 0, 479.5], [0, 643.2, 299.5], [0, 0, 1]], np.float32)
    P, N, Hyp = 3, 600, 1024
    T = se3_exp(torch.tensor([0.02, -0.01, 0.15, 0.01, -0.02, 0.005], dtype=torch.float64)).numpy()
    X = np.stack([rng.uniform(-4, 4, (P, N)), rng.uniform(-1.5, 1.5, (P, N)), rng.uniform(3, 25, (P, N))], -1)
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = pc[..., :2] / pc[..., 2:] * Kmat[0, 0] + Kmat[:2, 2] + rng.normal(size=(P, N, 2)) * 0.2
    bad = rng.random((P, N)) < 0.6
    uv[bad] += rng.uniform(-40, 40, (int(bad.sum()), 2))
    valid = rng.random((P, N)) > 0.05
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (P, Hyp, N))))
    U = rng.uniform(1e-9, 1.0, (P, N))
    w = rng.uniform(0.05, 1.0, (P, N))
    out = []
    for d in ("cpu", dev):
        cam = PinholeCamera(K=torch.as_tensor(Kmat, device=d), dist=torch.zeros(5, device=d), width=960, height=600)
        f = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=d)
        out.append(solve_pnp_ransac(f(X), f(uv), f(valid, torch.bool), cam, n_hypotheses=Hyp, weights=f(w),
                                    minimal="p3p", gumbel=f(G), uniform=f(U)))
    cpu, card = out
    assert bool(card.ok.all()) and bool(cpu.ok.all())
    torch.testing.assert_close(card.R.cpu(), cpu.R, rtol=0, atol=1e-3)
    torch.testing.assert_close(card.t.cpu(), cpu.t, rtol=0, atol=1e-3)
    assert (card.n_inliers.cpu() - cpu.n_inliers).abs().max() <= 3
    assert (cpu.t - torch.as_tensor(T[:3, 3], dtype=torch.float32)).abs().max() < 0.05


def test_attention_grads_card_match_plain_autograd(cuda):
    """The attention Function under autograd on the card, at the training
    step's K = S = 48 with masked sources and a fully masked sequence: its
    forward is one kernel launch (bf16 bound as above), its backward
    launches nothing and equals the plain version's autograd bit for bit
    (it is that recompute)."""
    dev, g = cuda
    B, h, K_, dh = 6, 4, 48, 64
    scale = 1.0 / dh ** 0.5
    leaf = lambda s: (torch.randn((B, h, K_, dh), generator=g, device=dev) * s).to(torch.bfloat16).requires_grad_()
    q, k, v = leaf(2.0), leaf(2.0), leaf(1.0)
    mask = torch.rand((B, K_), generator=g, device=dev) < 0.7
    mask[-1] = False
    gout = torch.randn((B, h, K_, dh), generator=g, device=dev).to(torch.bfloat16)
    n = attention_forward.launches
    out = masked_attention(q, k, v, mask, scale)
    assert attention_forward.launches == n + 1
    grads = torch.autograd.grad(out, (q, k, v), gout)
    assert attention_forward.launches == n + 1
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = masked_attention_plain(q2, k2, v2, mask, scale)
    ref_grads = torch.autograd.grad(ref, (q2, k2, v2), gout)
    top = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= 2.0 ** -7 * top
    for got, want in zip(grads, ref_grads):
        assert torch.isfinite(got.float()).all() and got.float().abs().max() > 0
        assert torch.equal(got, want)


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_step_card_matches_cpu(cuda):
    """One training step of the full-width recipe (stem 2, 9 layer pairs,
    K = 48) at 4 pairs on the card against the CPU, same batch and
    parameters, within chip_smoke.TRAIN_AGREEMENT; then a train_step on the
    card launches attention 18 times and no other kernel, and moves every
    parameter."""
    import copy

    from forest_slam_tpu_torch.train.data import TrainingBatch, make_corridor_pool, make_training_batch
    from forest_slam_tpu_torch.train.trainer import create_train_state, train_step

    dev, g = cuda
    cs = _chip_smoke()
    cfg = cs.train_config()._replace(batch_size=4)
    state = create_train_state(cfg, seed=0, device=dev)
    pool = make_corridor_pool(g, 4, cfg.height, cfg.width, cfg.max_corners, chunk=4, device=dev)
    batch = make_training_batch(g, 4, cfg.height, cfg.width, cfg.max_corners, 0.4, 0.3, pool, dev)
    card = cs.step_gradients(state.frontend, batch, cfg)
    cpu = cs.step_gradients(copy.deepcopy(state.frontend).cpu(), TrainingBatch(*(t.cpu() for t in batch)), cfg)
    agree = cs.step_agreement(cpu, card)
    assert agree["ok"], agree
    before = [p.detach().clone() for p in state.frontend.parameters()]
    wrappers = [attention_forward, gnn_layer, sinkhorn_decode, nms_block_max, detect_pooled, sparse_cost_rows,
                refine_cost_volume]
    counts = [w.launches for w in wrappers]
    state, metrics = train_step(state, batch, cfg)
    torch.cuda.synchronize()
    assert [w.launches - c for w, c in zip(wrappers, counts)] == [18, 0, 0, 0, 0, 0, 0]
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(not torch.equal(a, p) for a, p in zip(before, state.frontend.parameters()))


def test_distill_step_card_matches_cpu(cuda):
    """One distillation step of chip_smoke.py's round-5 recipe (the stem-2
    teacher, a stem-4 student, every term on) on the card against the CPU,
    on the batch chip_smoke.DISTILL_AGREEMENT's bounds were measured on
    (chip_smoke.distill_setup), same teacher and student, within those
    bounds; then a distill_step on the card launches no kernel and moves
    every parameter."""
    import copy

    from forest_slam_tpu_torch.train.distill import distill_step, step_inputs, teacher_outputs

    dev, _ = cuda
    cs = _chip_smoke()
    cfg, (teacher, _, _), state, g, host, pool = cs.distill_setup(dev)
    inputs = step_inputs(g, host, cfg, pool)
    card = cs.distill_gradients(state.student, teacher_outputs(teacher, inputs[0]), inputs, cfg)
    cpu_inputs = (inputs[0].cpu(), tuple(t.cpu() for t in inputs[1]), inputs[2].cpu())
    cpu = cs.distill_gradients(copy.deepcopy(state.student).cpu(),
                               teacher_outputs(copy.deepcopy(teacher).cpu(), cpu_inputs[0]), cpu_inputs, cfg)
    agree = cs.distill_agreement(cpu, card)
    assert agree["ok"], agree
    before = [p.detach().clone() for p in state.student.parameters()]
    wrappers = [attention_forward, gnn_layer, sinkhorn_decode, nms_block_max, detect_pooled, sparse_cost_rows,
                refine_cost_volume]
    counts = [w.launches for w in wrappers]
    state, metrics = distill_step(state, teacher, inputs[0], cfg, inputs[1], inputs[2])
    torch.cuda.synchronize()
    assert [w.launches - c for w, c in zip(wrappers, counts)] == [0] * 7
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(not torch.equal(a, p) for a, p in zip(before, state.student.parameters()))


def test_sgm_card_equals_cpu_on_the_cv2_fixture(cuda):
    """The port's SGM on the card over the OpenCV fixture (600x960, D=96)
    equals its CPU result on every pixel: exact costs, first-index argmin,
    the same parabola division; and tests/test_stereo_disparity.py's bounds
    against cv2 and the ground truth hold."""
    dev, _ = cuda
    rec, failures = _chip_smoke().sgm_fixture_check(dev)
    assert not failures, rec
    assert rec["integer_equal_cpu"] and rec["max_abs_diff_cpu"] == 0.0


@pytest.mark.parametrize("minimal", ["8pt", "5pt"])
def test_mono_estimate_relative_pose_card_matches_cpu(cuda, minimal):
    """estimate_relative_pose on the card against the CPU with the same
    draws: 3 pairs of tests/test_geometry.py's scene (256 points, noise
    5e-4, 30% outliers), 1024 hypotheses. The card rounds differently (its
    SVD, fused multiply-adds), which can move a near-tie among hypotheses:
    inlier counts within 1, rotations within 0.05 degrees."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from forest_slam_tpu_torch.geometry.epipolar import estimate_relative_pose

    dev, _ = cuda
    rng = np.random.default_rng(4)
    P, N, Hyp, thr = 3, 256, 1024, 1.0 / 640.0
    x0s, x1s = [], []
    for _ in range(P):
        pts = rng.uniform([-2, -1.5, 4], [2, 1.5, 12], size=(N, 3))
        R = Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_matrix()
        p1 = pts @ R.T + rng.normal(size=3) * 0.3
        x0 = pts[:, :2] / pts[:, 2:] + rng.normal(scale=5e-4, size=(N, 2))
        x1 = p1[:, :2] / p1[:, 2:] + rng.normal(scale=5e-4, size=(N, 2))
        x1[: int(0.3 * N)] = rng.uniform(-0.5, 0.5, size=(int(0.3 * N), 2))
        x0s.append(x0)
        x1s.append(x1)
    G = -np.log(-np.log(rng.uniform(1e-12, 1.0, (P, Hyp, N))))
    out = []
    for d in ("cpu", dev):
        f = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=d)  # noqa: E731
        out.append(estimate_relative_pose(f(x0s), f(x1s), torch.ones((P, N), dtype=torch.bool, device=d), thr, f(G),
                                          minimal=minimal))
    cpu, card = out
    assert bool(cpu.ok.all()) and bool(card.ok.all())
    assert (card.n_inliers.cpu() - cpu.n_inliers).abs().max() <= 1
    rel = card.R.cpu().double().transpose(-1, -2) @ cpu.R.double()
    ang = torch.rad2deg(torch.arccos(torch.clamp((rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2, -1, 1)))
    assert ang.max() < 0.05, ang


def test_mono_learned_run_card_matches_cpu(cuda):
    """The learned mono path (the flagship at K=512, parity and the 5-point
    solver, 256 hypotheses) over 8 corridor frames at 480x320 on a steady
    turn of 4 degrees a pair, on the card through select, gnn_layer and
    sinkhorn_decode, against the CPU's plain versions with the same draws.
    The GNN layer rounds to bf16 on the card, which moves a few matches (up
    to 4 of 190 on the H100) and with them RANSAC's winner. Held: the same
    pairs tracked, match counts within 5%, inlier counts within 10%, each
    pair's camera rotation within 1 degree of the CPU's (reading: 0-0.84,
    against the turn's 4), the mean rotation error against the turn below
    0.75 degrees on both (readings: card 0.29, CPU 0.27; an identity
    rotation is 4 degrees off), and the card's within 0.15 degrees of the
    CPU's."""
    import numpy as np

    from forest_slam_tpu_torch.core.lie import se3_inverse
    from forest_slam_tpu_torch.frontend.base import learned_frontend
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.io.synthetic import default_rig, make_corridor_world, render_stereo, turning_trajectory
    from forest_slam_tpu_torch.pipelines.mono import MonoConfig, run_mono_vo

    dev, _ = cuda
    H, W, n = 320, 480, 8
    rig = default_rig(H, W, device="cpu")
    Ts = turning_trajectory(n, 4.0, device="cpu")
    images = render_stereo(make_corridor_world(3, device="cpu"), Ts, rig, H, W)[0]
    cfg = MonoConfig(n_hypotheses=256)
    out = []
    for d in ("cpu", dev):
        fe = load_learned_frontend(FLAGSHIP_PATH, (H, W), 512, device=d)
        counts = [w.launches for w in (nms_block_max, gnn_layer, sinkhorn_decode)]
        _, o = run_mono_vo(images, np.arange(n) * 0.1, rig.left, cfg, frontend=learned_frontend(fe), device=d)
        launched = [w.launches - c for w, c in zip((nms_block_max, gnn_layer, sinkhorn_decode), counts)]
        assert all(k > 0 for k in launched) == (d != "cpu")
        out.append(type(o)(*(t.cpu() for t in o)))
    cpu, card = out

    def angle(R):
        return torch.rad2deg(torch.arccos(torch.clamp((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2, -1, 1)))

    def camera_motion(pose):  # parity chains point transforms: each pair's camera motion is the inverse
        P = torch.cat([torch.eye(4, dtype=torch.float64)[None], pose.double()])
        return se3_inverse(se3_inverse(P[:-1]) @ P[1:])

    gt = Ts.double()
    true = se3_inverse(gt[:-1]) @ gt[1:]
    m_cpu, m_card = camera_motion(cpu.pose), camera_motion(card.pose)
    diff = angle(m_card[:, :3, :3].transpose(-1, -2) @ m_cpu[:, :3, :3])
    err_cpu = angle(true[:, :3, :3].transpose(-1, -2) @ m_cpu[:, :3, :3])
    err_card = angle(true[:, :3, :3].transpose(-1, -2) @ m_card[:, :3, :3])
    print("mono learned card vs CPU: matches", card.n_matches.tolist(), cpu.n_matches.tolist(), "inliers",
          card.n_inliers.tolist(), cpu.n_inliers.tolist(), "rotation differences (degrees)", diff.tolist(),
          "errors against the truth, card", err_card.tolist(), "CPU", err_cpu.tolist())
    assert torch.equal(card.ok, cpu.ok) and int(cpu.ok.sum()) >= 6
    assert ((card.n_matches - cpu.n_matches).abs() <= 0.05 * cpu.n_matches).all(), (card.n_matches, cpu.n_matches)
    assert ((card.n_inliers - cpu.n_inliers).abs() <= 0.1 * cpu.n_inliers).all(), (card.n_inliers, cpu.n_inliers)
    assert diff.max() < 1.0, diff
    assert err_cpu.mean() < 0.75 and err_card.mean() < 0.75, (err_card, err_cpu)
    assert err_card.mean() <= err_cpu.mean() + 0.15, (err_card, err_cpu)


def _slam_graph(rng, n=40):
    """A drifting chain of n poses with odometry and four loop edges that
    measure the true relative motions (float32 tensors): (poses, ei, ej, Z,
    w)."""
    import numpy as np

    from forest_slam_tpu_torch.core.lie import se3_exp

    steps = torch.as_tensor(np.concatenate([rng.normal(0, 0.02, (n - 1, 3)) + [0, 0, 0.5],
                                            rng.normal(0, 0.05, (n - 1, 3))], 1))
    T = [torch.eye(4, dtype=torch.float64)]
    for xi in steps:
        T.append(T[-1] @ se3_exp(xi))
    truth = torch.stack(T)
    ei = list(range(n - 1)) + [0, 5, 10, 20]
    ej = list(range(1, n)) + [30, 35, 39, 33]
    Z = torch.stack([torch.linalg.inv(truth[i]) @ truth[j] for i, j in zip(ei, ej)])
    w = torch.ones(len(ei))
    w[n - 1:] = 3.0
    drift = truth @ se3_exp(torch.as_tensor(rng.normal(0, 0.03, (n, 6))))
    drift[0] = truth[0]
    return drift.float(), torch.tensor(ei), torch.tensor(ej), Z.float(), w, truth.float()


def test_slam_pose_graph_card_equals_cpu(cuda):
    """optimize_pose_graph on a 40-node drifting chain with four loop edges
    (a 234-wide solve), card against CPU: the normal matrix is summed in
    float64 from one-hot products, in the same order on both; the solve and
    the lie algebra round differently. The edges agree with one another (the
    truth), so Gauss-Newton converges: where edges conflict, float32
    Gauss-Newton wanders at so3_log's arccos resolution in the JAX package
    and the port alike (ROADMAP Queue C). Poses within 1e-4 of each other
    and of the truth, the final cost below 1e-6 of the initial."""
    import numpy as np

    from forest_slam_tpu_torch.backend.pose_graph import PoseGraph, optimize_pose_graph

    dev, _ = cuda
    *g, truth = _slam_graph(np.random.default_rng(0))
    cpu = optimize_pose_graph(PoseGraph(*g))
    card = optimize_pose_graph(PoseGraph(*(a.to(dev) for a in g)))
    diff = (card.poses.cpu() - cpu.poses).abs().max().item()
    costs = [float(x) for x in (cpu.initial_cost, cpu.final_cost, card.final_cost)]
    assert diff < 1e-4 and (cpu.poses - truth).abs().max() < 1e-4, (diff, costs)
    assert costs[1] < 1e-6 * costs[0] and costs[2] < 1e-6 * costs[0], costs


def test_slam_ba_card_equals_cpu(cuda):
    """ba_solve on a batch of three windows (5 poses, 300 landmarks, depths,
    Huber), card against CPU: poses within 1e-4, costs within 1e-4
    relative."""
    import numpy as np

    from forest_slam_tpu_torch.backend.ba import BAProblem, ba_solve
    from forest_slam_tpu_torch.core.camera import PinholeCamera, project_points
    from forest_slam_tpu_torch.core.lie import se3_exp

    dev, _ = cuda
    rng = np.random.default_rng(1)
    B, M, P = 3, 5, 300
    X = torch.as_tensor(np.stack([np.column_stack([rng.uniform(-4, 4, P), rng.uniform(-2, 2, P),
                                                   rng.uniform(3, 20, P)]) for _ in range(B)]))
    T = se3_exp(torch.as_tensor(np.stack([[[0, 0, -0.3 * m, 0, 0.01 * m, 0] for m in range(M)]] * B), dtype=torch.float64))
    cam = PinholeCamera.create(np.array([[320.0, 0, 159.5], [0, 320.0, 119.5], [0, 0, 1]]),
                               [-0.03, 0.01, 5e-4, -5e-4, 0.0], 320, 240, device="cpu", dtype=torch.float64)
    pc = (T[:, :, None, :3, :3] * X[:, None, :, None, :]).sum(-1) + T[:, :, None, :3, 3]
    obs = project_points(pc, cam) + torch.as_tensor(rng.normal(0, 0.3, (B, M, P, 2)))
    T0 = T @ se3_exp(torch.as_tensor(np.concatenate([rng.normal(0, 0.05, (B, M, 3)), rng.normal(0, 0.02, (B, M, 3))], -1)))
    T0[:, 0] = T[:, 0]
    args = dict(poses=T0, points=X + torch.as_tensor(rng.normal(0, 0.05, X.shape)), observations=obs,
                mask=torch.as_tensor(rng.random((B, M, P)) > 0.05), depths=pc[..., 2] * (1 + torch.as_tensor(rng.normal(0, 0.01, (B, M, P)))),
                depth_mask=torch.as_tensor(rng.random((B, M, P)) > 0.2))
    f32 = lambda d: {k: (v.float() if v.is_floating_point() else v).to(d) for k, v in args.items()}  # noqa: E731
    cam32 = lambda d: PinholeCamera(K=cam.K.float().to(d), dist=cam.dist.float().to(d), width=320, height=240)  # noqa: E731
    cpu = ba_solve(BAProblem(cam=cam32("cpu"), huber_px=1.0, **f32("cpu")), iters=8)
    card = ba_solve(BAProblem(cam=cam32(dev), huber_px=1.0, **f32(dev)), iters=8)
    assert (cpu.final_cost < cpu.initial_cost).all()
    assert (card.poses.cpu() - cpu.poses).abs().max() < 1e-4
    assert ((card.final_cost.cpu() / cpu.final_cost - 1).abs() < 1e-4).all()


def _slam_clip(dev, n=13, H=160, W=224, seed=3):
    from forest_slam_tpu_torch.io.synthetic import render_sequence

    seq = render_sequence(n, H, W, seed=seed, speed=0.25, device="cpu")
    move = lambda r: r._replace(left=r.left._replace(K=r.left.K.to(dev), dist=r.left.dist.to(dev)),  # noqa: E731
                                right=r.right._replace(K=r.right.K.to(dev), dist=r.right.dist.to(dev)),
                                T_left_right=r.T_left_right.to(dev))
    return seq, move


def test_slam_window_ba_card_equals_cpu(cuda):
    """refine_trajectory_ba with the anchors re-matched (ORB, Hamming: the
    same matches on both), on the card against the CPU over the same
    artifacts (13 corridor frames at 224x160, three windows): refined poses
    within 1e-4."""
    from forest_slam_tpu_torch.backend.window import StereoArtifacts, WindowBAConfig, refine_trajectory_ba
    from forest_slam_tpu_torch.frontend.base import orb_frontend
    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, run_stereo_vo_device

    dev, _ = cuda
    seq, move = _slam_clip(dev)
    cfg = StereoConfig(orb=OrbConfig(n_features=384, n_levels=4), n_hypotheses=256, compose_mode="odometry")
    front = orb_frontend(cfg.orb)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    outs, art = run_stereo_vo_device(seq.images_left.to(dev), seq.images_right.to(dev), move(seq.rig), cfg, g, front,
                                     return_artifacts=True)
    card = refine_trajectory_ba(outs.pose, art, move(seq.rig).left, WindowBAConfig(), frontend=front)
    to_cpu = lambda t: type(t)(*(x.cpu() for x in t))  # noqa: E731
    cpu_art = StereoArtifacts(*(x.cpu() for x in art[:5]), feats=to_cpu(art.feats))
    cpu = refine_trajectory_ba(outs.pose.cpu(), cpu_art, seq.rig.left, WindowBAConfig(), frontend=front)
    assert (card - outs.pose).abs().max() > 1e-4
    assert (card.cpu() - cpu).abs().max() < 1e-4


def test_slam_loop_verification_card_equals_cpu(cuda):
    """verify_loops over six candidate pairs in one batch, card against CPU
    with the same draws: ORB (Hamming, exact matches) accepted flags equal,
    the accepted pairs' inliers within 2 and edges within 1e-3; and the
    learned matcher (the flagship at K=512) over the same pairs' features
    (extracted on the CPU) in one batch on the card, through gnn_layer and
    sinkhorn_decode, against the CPU's plain versions: at least 97% of the
    valid keypoints' matches equal (the layer's bf16 rounding)."""
    import numpy as np

    from forest_slam_tpu_torch.backend.loop_closure import LoopClosureConfig, verify_loops
    from forest_slam_tpu_torch.frontend.base import learned_frontend, orb_frontend
    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.frontend.weights import FLAGSHIP_PATH, load_learned_frontend
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, frame_features

    dev, _ = cuda
    seq, move = _slam_clip(dev, n=7)
    pairs = torch.tensor([[0, 2], [1, 3], [0, 4], [2, 4], [3, 6], [0, 6]])
    C, HYP = pairs.shape[0], 256
    rng = np.random.default_rng(0)
    cfg = LoopClosureConfig(n_hypotheses=HYP, min_inliers=25)
    scfg = StereoConfig(orb=OrbConfig(n_features=384, n_levels=4))
    out = []
    for d in ("cpu", dev):
        rig = move(seq.rig) if d != "cpu" else seq.rig
        front = orb_frontend(scfg.orb)
        feats, z, z_ok = frame_features(seq.images_left.to(d), seq.images_right.to(d), rig, scfg, front)
        K = feats.xy.shape[1]
        G = torch.as_tensor(-np.log(-np.log(np.random.default_rng(0).uniform(1e-12, 1.0, (HYP, K)))), dtype=torch.float32)
        U = torch.as_tensor(np.random.default_rng(1).uniform(1e-9, 1.0, K), dtype=torch.float32)
        out.append(verify_loops(pairs.to(d), torch.ones(C, dtype=torch.bool, device=d), feats, z, z_ok, rig.left, front,
                                (160, 224), cfg, None, gumbel=G.to(d).expand(C, -1, -1), uniform=U.to(d).expand(C, -1)))
    (cZ, cn, ca), (gZ, gn, ga) = out
    assert ca[:2].all() and torch.equal(ga.cpu(), ca), (ca, ga, cn, gn)
    # an accepted pair's inliers within 2; a weak rejected pair may move by
    # more (13 and 16 of 256 hypotheses' near-ties, pair (0, 4) on the H100)
    assert (gn.cpu() - cn)[ca].abs().max() <= 2, (cn, gn)
    assert (gZ.cpu()[ca] - cZ[ca]).abs().max() < 1e-3
    # the learned matcher on the same features (the CPU's extraction) on both devices
    fes = {d: load_learned_frontend(FLAGSHIP_PATH, (160, 224), 512, device=d) for d in ("cpu", dev)}
    with torch.no_grad():
        f = fes["cpu"].extract(seq.images_left)
        sel = lambda i, d: type(f)(*(a[pairs[:, i]].to(d) for a in f))  # noqa: E731
        matches = [learned_frontend(fes[d]).match(sel(0, d), sel(1, d), (160, 224)).cpu() for d in ("cpu", dev)]
    valid = f.valid[pairs[:, 0]]
    assert ((matches[0] >= 0).sum(-1) >= 50).all()  # 59-77 a pair on the CPU
    agree = (matches[0] == matches[1])[valid].float().mean()
    assert agree >= 0.97, agree


def test_slam_streaming_equals_scan_on_card(cuda, tmp_path):
    """The sequential runner on the card: streaming in chunks of 3 gives the
    scan's poses exactly (the same steps, the same generator), tracks the
    batched run's pairs, and writes the trajectory it returns."""
    import numpy as np

    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.io.tum import read_tum
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, run_stereo_vo, run_stereo_vo_streaming

    dev, _ = cuda
    seq, move = _slam_clip(dev, n=9)
    il, ir, rig = seq.images_left.to(dev), seq.images_right.to(dev), move(seq.rig)
    cfg = StereoConfig(orb=OrbConfig(n_features=384, n_levels=4), n_hypotheses=256, compose_mode="odometry")
    path = str(tmp_path / "stream.txt")
    traj, stream = run_stereo_vo_streaming(il, ir, seq.timestamps, rig, cfg, path, seed=2, chunk=3)
    _, scan = run_stereo_vo(il, ir, seq.timestamps, rig, cfg, seed=2, mode="scan")
    _, batched = run_stereo_vo(il, ir, seq.timestamps, rig, cfg, seed=2)
    assert torch.equal(stream.pose, scan.pose.cpu()) and torch.equal(stream.ok, scan.ok.cpu())
    assert torch.equal(scan.ok, batched.ok) and bool(scan.ok.all())
    assert np.abs(read_tum(path).positions - traj.positions).max() < 1e-5


def test_bag_loader_card_matches_cpu(cuda, tmp_path):
    """``load_stereo_from_bag`` onto the card (the BotanicGarden rig, 960x600
    bgr8 frames of noise) within 1e-3 grey levels of the CPU's, by the
    native reader on both."""
    import numpy as np

    from forest_slam_tpu_torch.io import calib
    from forest_slam_tpu_torch.io.dataset import load_stereo_from_bag
    from forest_slam_tpu_torch.io.synthetic import write_stereo_bag

    dev, _ = cuda
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 5, 600, 960)).astype(np.float32)
    path = str(tmp_path / "b.bag")
    write_stereo_bag(path, frames[0], frames[1], 1.6e9 + 0.1 * np.arange(5))
    card = load_stereo_from_bag(path, calib.botanic_garden_rig(dev), frame_stride=2, device=dev)
    cpu = load_stereo_from_bag(path, calib.botanic_garden_rig("cpu"), frame_stride=2, device="cpu")
    assert card.reader == cpu.reader == "native" and card.images_left.device.type == "cuda"
    for a, b in ((card.images_left, cpu.images_left), (card.images_right, cpu.images_right)):
        assert a.shape == (3, 600, 960)
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(card.timestamps, cpu.timestamps)


# --sg-attention flash: the library's scaled_dot_product_attention against the
# dense path (bf16 logits) and the plain version (float32 logits, the
# attention kernel's numerics), with the last sequence's sources all masked;
# tolerances as tests/test_torch_bench_flags.py's flash_tolerances
@pytest.mark.parametrize("shape", [(16, 4, 1024, 1024), (3, 4, 150, 130)])
def test_flash_attention_against_the_dense_path(cuda, shape):
    from forest_slam_tpu_torch.frontend.superglue import attention, dense_attention

    dev, g = cuda
    B, h, K, S = shape
    q = (torch.randn((B, h, K, 64), generator=g, device=dev) * 2).to(torch.bfloat16)
    k = (torch.randn((B, h, S, 64), generator=g, device=dev) * 2).to(torch.bfloat16)
    v = torch.randn((B, h, S, 64), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.rand((B, S), generator=g, device=dev) < 0.7
    mask[-1] = False
    flash = attention(q, k, v, mask, "flash").float()
    dense = dense_attention(q, k, v, mask, "bfloat16").float()
    plain = masked_attention_plain(q, k, v, mask, 1.0 / 8.0).float()
    top = dense.abs().max()
    assert torch.isfinite(flash).all()
    assert (flash - dense).abs().max() <= 2.0 ** -5 * top and (flash - dense).abs().mean() <= 2.0 ** -9 * top
    assert (flash - plain).abs().max() <= 2.0 ** -7 * top and (flash - plain).abs().mean() <= 1e-3 * top
    assert (flash[-1] - v[-1].float().mean(dim=1, keepdim=True)).abs().max() <= 2.0 ** -7


# --refine-cost-path pallas (the kernel, strictly) against xla (the plain
# version) through the refinement, on integer images: equal
def test_refine_cost_path_pallas_equals_xla(cuda):
    from forest_slam_tpu_torch.frontend.refine import RefineConfig, refine_matches_quality

    dev, g = cuda
    img0, img1 = (torch.randint(0, 256, (4, 600, 960), generator=g, device=dev).float() for _ in range(2))
    xy0 = torch.rand((4, 1024, 2), generator=g, device=dev) * torch.tensor([959.0, 599.0], device=dev)
    xy1 = xy0 + torch.randn((4, 1024, 2), generator=g, device=dev) * 3
    valid = torch.rand((4, 1024), generator=g, device=dev) < 0.8
    for scales in ((1.0,), (1.0, 1.2)):
        a, b = (refine_matches_quality(img0, img1, xy0, xy1, valid, RefineConfig(radius=12, cost_path=p, scales=scales))
                for p in ("pallas", "xla"))
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_multichip_sharded_step_matches_train_step(cuda):
    """make_sharded_train_step on make_mesh(1) (one NCCL rank) at the
    full-width recipe, 4 pairs: loss terms and gradients against the
    unsharded step within chip_smoke.TRAIN_AGREEMENT, the update's norm
    within 5%, attention launched 18 times by the step and nothing else."""

    from forest_slam_tpu_torch.parallel import make_mesh
    from forest_slam_tpu_torch.train.data import make_corridor_pool, make_training_batch
    from forest_slam_tpu_torch.train.trainer import create_train_state, make_sharded_train_step, train_step

    dev, g = cuda
    cs = _chip_smoke()
    cfg = cs.train_config()._replace(batch_size=4)
    mesh = make_mesh(1, "cuda")
    state = create_train_state(cfg, seed=0, device=dev)
    pool = make_corridor_pool(g, 4, cfg.height, cfg.width, cfg.max_corners, chunk=4, device=dev)
    batch = make_training_batch(g, 4, cfg.height, cfg.width, cfg.max_corners, 0.4, 0.3, pool, dev)
    ref = cs.step_gradients(state.frontend, batch, cfg)
    step, sharded = make_sharded_train_step(mesh, state, cfg)
    host = lambda grads: {n: v.detach().double().cpu().numpy().ravel() for n, v in grads.items()}
    _, g_sp = step.gradients(sharded, batch, of=lambda m: m["detector"] + m["descriptor"])
    metrics, g_all = step.gradients(sharded, batch)
    agree = cs.step_agreement(ref, ({k: float(v) for k, v in metrics.items()}, host(g_all), host(g_sp)))
    assert agree["ok"], agree
    start = {n: p.detach().clone() for n, p in state.frontend.named_parameters()}
    counts = [w.launches for w in (attention_forward, gnn_layer, sinkhorn_decode, nms_block_max, detect_pooled,
                                   sparse_cost_rows, refine_cost_volume)]
    sharded, _ = step(sharded, batch)
    torch.cuda.synchronize()
    assert [w.launches - c for w, c in zip((attention_forward, gnn_layer, sinkhorn_decode, nms_block_max,
                                            detect_pooled, sparse_cost_rows, refine_cost_volume),
                                           counts)] == [18, 0, 0, 0, 0, 0, 0]
    state, _ = train_step(state, batch, cfg)
    norm = lambda new: float(sum(float(((new[n] - start[n]).double() ** 2).sum()) for n in start) ** 0.5)
    n_ref = norm({n: p.detach() for n, p in state.frontend.named_parameters()})
    assert n_ref > 0 and abs(norm(step.parameters(sharded)) - n_ref) <= 5e-2 * n_ref
    assert sharded.step == 1 and len(sharded.shards) == 0  # model = 1: nothing sharded


def test_multichip_batched_eval_equals_each_sequence(cuda):
    """run_batched_eval on make_mesh(1) over 2 distinct 224x160 sequences,
    ORB: each sequence's poses and ok flags equal run_stereo_vo_device's on
    it alone with its generator seeded from (seed, s), bit for bit."""
    import numpy as np

    from forest_slam_tpu_torch.frontend.base import orb_frontend
    from forest_slam_tpu_torch.io.synthetic import render_sequence
    from forest_slam_tpu_torch.parallel import make_mesh
    from forest_slam_tpu_torch.pipelines.batch_eval import run_batched_eval, sequence_seed
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig, run_stereo_vo_device

    dev, _ = cuda
    seqs = [render_sequence(8, height=160, width=224, seed=s, speed=0.10 + 0.03 * s, device=dev) for s in range(2)]
    il = torch.stack([q.images_left for q in seqs])
    ir = torch.stack([q.images_right for q in seqs])
    gt = torch.stack([q.T_world_cam for q in seqs])
    cfg = StereoConfig(orb=OrbConfig(n_features=256, n_levels=3), n_hypotheses=128, compose_mode="odometry")
    results, poses, ok = run_batched_eval(il, ir, gt, seqs[0].rig, cfg, make_mesh(1, "cuda"), frame_batch=4,
                                          pair_batch=4, with_ok=True)
    assert ok.mean() > 0.9 and len({round(r.ate_rmse, 6) for r in results}) == 2
    for s in range(2):
        gen = torch.Generator(device=dev)
        gen.manual_seed(sequence_seed(0, s))
        alone = run_stereo_vo_device(il[s], ir[s], seqs[0].rig, cfg, gen, orb_frontend(cfg.orb, cfg.max_match_distance),
                                     frame_batch=4, pair_batch=4)
        assert np.array_equal(poses[s], alone.pose.double().cpu().numpy())
        assert np.array_equal(ok[s], alone.ok.cpu().numpy())


def _agree(got, args):
    """chip_smoke.pnp_refine_agreement's check of the kernel's result
    against the plain version on the same arguments."""
    a = _chip_smoke().pnp_refine_agreement(got, args)
    assert a["ok"], a


# P pairs of N points, the minimal solver, the identity start's anneal (0: none)
@pytest.mark.parametrize("P, N, minimal, identity", [
    (1, 512, "dlt6", 48.0), (2, 700, "dlt6", 0.0), (2, 700, "p3p", 48.0), (48, 1024, "dlt6", 48.0),
    (48, 1024, "p3p", 0.0), (192, 512, "dlt6", 48.0), (192, 1024, "dlt6", 0.0), (1, 1024, "p3p", 48.0)])
def test_pnp_refine_kernel(cuda, P, N, minimal, identity):
    """csrc/pnp_refine.cu against pnp_kernel.refine_and_select_plain on the
    card, one launch a call."""
    from forest_slam_tpu_torch.geometry.pnp_kernel import refine_and_select

    dev, _ = cuda
    args = _chip_smoke().pnp_stage_args(dev, P, N, minimal, identity)
    n = refine_and_select.launches
    got = refine_and_select(*args)
    assert refine_and_select.launches == n + 1
    _agree(got, args)
    assert got.ok.float().mean() > 0.9


@pytest.mark.parametrize("minimal, identity", [("dlt6", 48.0), ("dlt6", 0.0), ("p3p", 48.0)])
def test_pnp_refine_kernel_distorted_camera(cuda, minimal, identity):
    """256 hypotheses and BotanicGarden's distorted left camera, as the bag
    and the CLI run, on six seeds of 48 pairs of 1024 points: every pair
    agrees but those chip_smoke.pnp_degenerate marks (the plain version
    refines the chosen start through a step that gates one or two points),
    and those that differ are at most PNP_MAX_APART of each call's pairs;
    the counts are printed."""
    from forest_slam_tpu_torch.geometry.pnp_kernel import refine_and_select

    dev, _ = cuda
    cs = _chip_smoke()
    seen = []
    for seed in range(6):
        args = cs.pnp_stage_args(dev, 48, 1024, minimal, identity, seed=seed, n_hypotheses=256, camera="botanic")
        a = cs.pnp_refine_agreement(refine_and_select(*args), args)
        assert a["ok"], (seed, a)
        seen.append((a["degenerate"], a["apart"], a["nan_pairs"]))
    print(f"{minimal}, identity {identity}: (degenerate, apart, NaN in both) pairs of 48 a seed: {seen}")


def test_pnp_refine_kernel_nan_and_many_starts(cuda):
    """A NaN hypothesis among the starts gives a NaN candidate, whose NaN
    score wins as torch.argmax lets it, in both versions; eight starts and
    no refinement steps run too."""
    from forest_slam_tpu_torch.geometry.pnp_kernel import refine_and_select
    from forest_slam_tpu_torch.geometry.ransac import stable_topk

    dev, _ = cuda
    Ps, inl, top, *rest = _chip_smoke().pnp_stage_args(dev, 4, 700, "dlt6", 48.0)
    Ps = Ps.clone()
    Ps[1, top[1, 1]] = float("nan")
    args = (Ps, inl, top, *rest)
    got = refine_and_select(*args)
    assert bool(torch.isnan(got.t[1]).all()) and int(got.n_inliers[1]) == 0 and not bool(got.ok[1])
    _agree(got, args)
    Ps, inl, top, *rest = _chip_smoke().pnp_stage_args(dev, 3, 512, "dlt6", 48.0, seed=1)
    top8 = stable_topk(inl.sum(-1), 8)
    for iters in (0, 8):
        args = (Ps, inl, top8, *rest[:5], iters, *rest[6:])
        _agree(refine_and_select(*args), args)


def test_pnp_refine_kernel_refuses(cuda):
    from forest_slam_tpu_torch.geometry.pnp_kernel import MAX_POINTS, refine_and_select

    dev, _ = cuda
    Ps, inl, top, p3, p2, v, cam, *rest = _chip_smoke().pnp_stage_args(dev, 2, 300, "dlt6", 48.0)
    with pytest.raises(ValueError, match="starts"):
        refine_and_select(Ps, inl, torch.zeros((2, 9), dtype=torch.int64, device=dev), p3, p2, v, cam, *rest)
    with pytest.raises(ValueError, match="float32"):
        refine_and_select(Ps, inl, top, p3.double(), p2, v, cam, *rest)
    big = torch.zeros((2, MAX_POINTS + 1, 3), device=dev)
    with pytest.raises(ValueError, match="points"):
        refine_and_select(Ps, inl, top, big, big[..., :2], big[..., 0] > 0, cam, *rest)


def test_solve_pnp_ransac_makes_no_host_sync(cuda):
    """DLT-6 PnP-RANSAC at the learned cell's chunk (48 pairs, N = 1024, 1024
    hypotheses) with its draws handed in runs under sync debug mode "error":
    nothing in it waits on the card."""
    import numpy as np

    from forest_slam_tpu_torch.geometry.pnp import solve_pnp_ransac
    from forest_slam_tpu_torch.geometry.ransac import gumbel_noise

    dev, g = cuda
    _, _, _, p3, p2, valid, cam, *_ = _chip_smoke().pnp_stage_args(dev, 48, 1024, "dlt6", 48.0)
    G = gumbel_noise((48, 1024, 1024), g, dev)
    U = 1e-9 + (1.0 - 1e-9) * torch.rand((48, 1024), generator=g, device=dev)
    solve_pnp_ransac(p3, p2, valid, cam, n_hypotheses=1024, gumbel=G, uniform=U)  # warm: build and first use
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = solve_pnp_ransac(p3, p2, valid, cam, n_hypotheses=1024, gumbel=G, uniform=U)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.mean(res.ok.cpu().numpy()) > 0.9


# ---------------------------------------------------------------- LightGlue

LG_PAIRS, LG_K = 48, 2048  # the sp_lightglue.seq962 cell's pair chunk and keypoints
# sha256 of superglue_layer_digest's output bits from the layer kernel as it
# was before LightGlue's variants (commit bd00a35, an H100 80GB HBM3)
SUPERGLUE_LAYER_SHA256 = "32baba2bdc47ba211db144fff9f3840dea3e74c145428bfae96ce701aa2a0ed6"


def superglue_layer_digest(dev) -> str:
    """sha256 of the SuperGlue layer kernel's bf16 output on a fixed input:
    16 sequences of 1024 x 256, a ragged source mask with one sequence all
    masked, numpy-drawn weights."""
    import numpy as np

    from forest_slam_tpu_torch.frontend.gnn_kernel import gnn_layer, split_layer_params

    rng = np.random.default_rng(20251018)
    D, N, K = 256, 16, 1024
    lp = {
        "attn": {n: {"kernel": rng.normal(size=(D, D)) * 0.06, "bias": rng.normal(size=D) * 0.1}
                 for n in ("q", "k", "v", "merge")},
        "mlp0": {"kernel": rng.normal(size=(2 * D, 2 * D)) * 0.04, "bias": rng.normal(size=2 * D) * 0.1},
        "ln": {"scale": 1 + rng.normal(size=2 * D) * 0.1, "bias": rng.normal(size=2 * D) * 0.1},
        "mlp1": {"kernel": rng.normal(size=(2 * D, D)) * 0.04, "bias": rng.normal(size=D) * 0.1},
    }
    ws = split_layer_params(lp, 4, device=dev)
    x = torch.as_tensor(rng.normal(size=(N, K, D)), dtype=torch.float32).to(torch.bfloat16).to(dev)
    src = torch.as_tensor(rng.normal(size=(N, K, D)), dtype=torch.float32).to(torch.bfloat16).to(dev)
    mask = torch.as_tensor(rng.random((N, K)) < 0.8).to(dev)
    mask[-1] = False
    with torch.no_grad():
        out = gnn_layer(x, src, mask, ws, 4)
    return hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()


def test_superglue_layer_bits_unchanged_by_the_lightglue_variants(cuda):
    assert superglue_layer_digest(cuda[0]) == SUPERGLUE_LAYER_SHA256


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_lightglue_layer_variants_kernel(cuda, kind):
    """The rotary + GELU (self) and shared-q/k + GELU (cross) layer against
    its plain version at the cell's shape. Both round to bf16 at the same
    points; float32 sums in another order move a value across a bf16
    boundary here and there, and that ulp (2^-8 relative) can pass through
    the LayerNorm and GELU to the output: the largest gap within 2^-5 of the
    output's largest magnitude, the mean within 2^-10 (the GNN layer
    kernel's own test allows 0.05 and 2e-3). The plain version on fp8
    inputs and weights misses the mean. chip_smoke.py's kernel phase holds
    the same case (chip_smoke.lightglue_layer_case)."""
    cs = _chip_smoke()
    c = cs.lightglue_layer_case(cuda[0], kind)
    (kmax, kmean), (cmax, cmean) = c["kernel"], c["control"]
    assert c["finite"]
    assert kmax <= cs.LG_LAYER_MAX == 2 ** -5 and kmean <= cs.LG_LAYER_MEAN == 2 ** -10
    assert cmean > cs.LG_LAYER_MEAN


def lightglue_score_gaps(dev):
    """(kernel path's, fp8 control's) gaps of the 9-layer matcher's scores
    at full-strength weights against the bf16 reference on each pair's
    valid keypoints: (largest, mean) over each pair's largest score
    magnitude, and the share of valid keypoints whose match (or none)
    differs."""
    from bench_port.reference import lightglue as ref
    from bench_port.reference.common import Precision
    from forest_slam_tpu_torch.frontend.lightglue import LightGlue, LightGlueConfig

    cfg, sd, xy0, d0, v0, xy1, d1, v1 = _chip_smoke().lightglue_inputs(dev, 9)
    lg = LightGlue(LightGlueConfig(), sd, device=dev)
    B = LG_PAIRS
    with torch.no_grad():
        x0, r0 = lg.encode(xy0, d0, (600, 960))
        x1, r1 = lg.encode(xy1, d1, (600, 960))
        rope = torch.cat([r0, r1]).contiguous()
        for i in range(9):
            xs = lg.self_block(i, torch.cat([x0, x1]).contiguous(), torch.cat([v0, v1]), rope)
            x0, x1 = lg.cross_block(i, xs[:B], xs[B:], v0, v1)
        scores = lg.log_assignment(x0, x1, v0, v1)
        got = lg.filter(scores, v0, v1)
    net = ref.load_weights(sd, dev)
    out = []
    for prec in (ref.SOUND, Precision(lower=True)):
        mx, mean, differ, total = 0.0, 0.0, 0, 0
        for b in range(B):
            s, m = ref.forward_pair(xy0[b][v0[b]], d0[b][v0[b]], xy1[b][v1[b]], d1[b][v1[b]], net, cfg, (600, 960),
                                    prec)
            gap = (scores[b][v0[b]][:, v1[b]] - s).abs() / s.abs().max()
            mx, mean = max(mx, gap.max().item()), mean + gap.mean().item() / B
            i1 = torch.nonzero(v1[b])[:, 0]
            want = torch.where(m >= 0, i1[m.clamp(min=0)], torch.full_like(m, -1))
            differ += int((got[b][v0[b]].long() != want).sum())
            total += int(v0[b].sum())
        out.append((mx, mean, differ / total))
    return out


def test_lightglue_scores_against_the_reference(cuda):
    """The whole matcher at the cell's shape (9 layers, 48 pairs of 1700-2048
    valid keypoints, residual_scale 1) against the plain reference at the
    configuration's precision. Through 18 full-strength blocks a bf16
    rounding that the two sides take differently grows, so the scores are
    held to their size: the largest gap within 2^-5 of a pair's largest
    score magnitude, the mean within 2^-8, and at most 1% of the keypoints
    matched differently (on the H100: 0.0108, 0.0014 and 0.05%). The
    reference one precision below (fp8 operands) misses the largest gap and
    the mean (0.113 and 0.0143)."""
    (kmax, kmean, kdiff), (cmax, cmean, cdiff) = lightglue_score_gaps(cuda[0])
    assert kmax <= 2 ** -5 and kmean <= 2 ** -8 and kdiff <= 0.01
    assert cmax > 2 ** -5 and cmean > 2 ** -8


def test_lightglue_match_makes_no_host_sync(cuda):
    """The matcher at the cell's shape under sync debug mode "error":
    nothing in it waits on the card."""
    from forest_slam_tpu_torch.frontend.lightglue import LightGlue, LightGlueConfig

    dev = cuda[0]
    cfg, sd, xy0, d0, v0, xy1, d1, v1 = _chip_smoke().lightglue_inputs(dev, 9, residual_scale=0.01)
    lg = LightGlue(LightGlueConfig(), sd, device=dev)
    lg.match(xy0, d0, v0, xy1, d1, v1, (600, 960))  # warm: build and first use
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = lg.match(xy0, d0, v0, xy1, d1, v1, (600, 960))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert m.shape == (LG_PAIRS, LG_K) and (m >= 0).sum().item() > 0.5 * v0.sum().item()


# run in a process of its own, so that no other profiler session in the
# test process comes before or after its recording
_LIGHTGLUE_SPANS_CHILD = r"""
import importlib.util, json, re, sys
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from forest_slam_tpu_torch.frontend.lightglue import LightGlue, LightGlueConfig
from forest_slam_tpu_torch.utils import trace

dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
cfg, sd, xy0, d0, v0, xy1, d1, v1 = cs.lightglue_inputs(dev, 2, residual_scale=0.01)
lg = LightGlue(LightGlueConfig(n_layers=2), sd, device=dev)
lg.match(xy0, d0, v0, xy1, d1, v1, (cs.H, cs.W))  # warm: build and first use
torch.cuda.synchronize()
with trace.recording(device=True) as tr:
    with trace.span("fs.frontend.match"):
        lg.match(xy0, d0, v0, xy1, d1, v1, (cs.H, cs.W))
rows = tr.summary()
layer = re.compile(r"\b(gemm_kernel|gnn_attention_kernel|layernorm_gelu_kernel)\b")
print(json.dumps(dict(
    launches=tr.launches, kernels=tr.kernels, lost=tr.lost_launches,
    self_ms=rows["fs.lightglue.self"]["kernel_ms"], cross_ms=rows["fs.lightglue.cross"]["kernel_ms"],
    match_ms=rows["fs.frontend.match"]["kernel_ms"], assign_ms=rows["fs.lightglue.assign"]["kernel_ms"],
    layer_ran_ms=sum(b - a for a, b, n in tr.device_events if layer.search(n)) / 1e3,
    kernels_ran_ms=sum(b - a for a, b, n in tr.device_events if not n.startswith(("Memcpy", "Memset"))) / 1e3)))
"""


def test_lightglue_spans_are_credited_the_fused_layers_kernels(cuda):
    """Under a device recording the join credits each kernel, by the
    profiler's correlation id, to the spans open over its launch call,
    wherever on the device's timeline it ran: the self and cross spans get
    all the device time of the fused layer's kernels (the matcher launches
    them nowhere else) and the little of the two sets' joins beside it, and
    the match span every kernel the recording saw. The recording runs in a
    process of its own (the port's library already built), so no other
    profiler session shares it; every launch call has its kernel records."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-c", _LIGHTGLUE_SPANS_CHILD], cwd=root, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["lost"] == 0 and r["launches"] <= r["kernels"]
    credited, ran = r["self_ms"] + r["cross_ms"], r["layer_ran_ms"]
    assert ran > 0 and ran * (1 - 1e-6) <= credited <= 1.05 * ran
    assert r["match_ms"] == pytest.approx(r["kernels_ran_ms"], rel=1e-6)
    assert r["assign_ms"] > 0

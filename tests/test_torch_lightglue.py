"""The port's LightGlue (frontend/lightglue.py) against the benchmark's plain
reference (bench_port/reference/lightglue.py), which runs each pair on its
valid keypoints alone, on the CPU at D=256, 4 heads, K=48 and 2 layers.

In float32 (``dtype=torch.float32`` against ``reference.lightglue.Float32``)
the two compute the same algorithm in differently ordered float32 sums (the
port batches padded pairs, merges heads in one loop and the FFN's input in
two products, computes S once a direction): every block's output agrees to
rtol 1e-5, the score matrix to 1e-5 of its largest magnitude, and the
matches are equal. A score is log_softmax(sim) = sim - logsumexp(sim), a
difference of numbers as large as the similarity (thousands here, after
``assign_scale`` 20 and two full-strength layers), so its float32 error
scales with the matrix, not with the entry. Weights are the benchmark's
draw at ``residual_scale`` 1, so every layer moves the tokens at full
strength.
"""

import math

import pytest
import torch

from bench_port import manifest
from bench_port.reference import lightglue as ref
from forest_slam_tpu_torch.frontend.gnn_kernel import rope_rotate
from forest_slam_tpu_torch.frontend.lightglue import LightGlue, LightGlueConfig, layer_weights, split_qkv
from _torch_threads import one_torch_thread  # noqa: F401

D, HEADS, K, LAYERS = 256, 4, 48, 2
IMAGE = (96, 128)
CFG = dict(descriptor_dim=D, num_heads=HEADS, lightglue_layers=LAYERS, filter_threshold=0.1,
           assumed=dict(residual_scale=1.0, assign_scale=20.0, matchability_bias=6.0))
RTOL = 1e-5  # float32 sums in other orders, through two layers


@pytest.fixture(scope="module")
def state_dict():
    return manifest.frontend("superpoint_lightglue").weights(CFG, manifest.ROOT, 2 ** 31 + 17, "cpu")


def _pairs(n_valid):
    """Two pairs of K slots; set 1 is set 0 permuted, moved by a pixel and
    with noisy descriptors, so there is something to match; the first
    n_valid[b] = (n0, n1) slots of each set are valid."""
    g = torch.Generator().manual_seed(5)
    B = len(n_valid)
    xy0 = torch.rand((B, K, 2), generator=g) * torch.tensor([IMAGE[1], IMAGE[0]], dtype=torch.float32)
    d0 = torch.nn.functional.normalize(torch.randn((B, K, D), generator=g), dim=-1)
    perm = torch.stack([torch.randperm(K, generator=g) for _ in range(B)])
    xy1 = xy0.gather(1, perm[..., None].expand(-1, -1, 2)) + 1.0
    d1 = torch.nn.functional.normalize(d0.gather(1, perm[..., None].expand(-1, -1, D))
                                       + 0.3 * torch.randn((B, K, D), generator=g), dim=-1)
    slots = torch.arange(K)
    v0 = torch.stack([slots < n0 for n0, _ in n_valid])
    v1 = torch.stack([slots < n1 for _, n1 in n_valid])
    return xy0, d0, v0, xy1, d1, v1


def _reference(xy0, d0, v0, xy1, d1, v1, sd, b):
    keep = []
    net = ref.load_weights(sd, "cpu")
    scores, m = ref.forward_pair(xy0[b][v0[b]], d0[b][v0[b]], xy1[b][v1[b]], d1[b][v1[b]], net, CFG, IMAGE,
                                 ref.Float32(), keep=keep)
    return keep, scores, m


def test_every_block_and_the_scores_agree_with_the_reference_in_float32(state_dict):
    xy0, d0, v0, xy1, d1, v1 = _pairs([(48, 48), (40, 31)])
    lg = LightGlue(LightGlueConfig(n_layers=LAYERS), state_dict, device="cpu", dtype=torch.float32)
    B = xy0.shape[0]
    x0, r0 = lg.encode(xy0, d0, IMAGE)
    x1, r1 = lg.encode(xy1, d1, IMAGE)
    states = []
    for i in range(LAYERS):
        xs = lg.self_block(i, torch.cat([x0, x1]), torch.cat([v0, v1]), torch.cat([r0, r1]))
        x0, x1 = xs[:B], xs[B:]
        states.append((x0, x1))
        x0, x1 = lg.cross_block(i, x0, x1, v0, v1)
        states.append((x0, x1))
    scores = lg.log_assignment(x0, x1, v0, v1)
    for b in range(B):
        keep, ref_scores, _ = _reference(xy0, d0, v0, xy1, d1, v1, state_dict, b)
        assert len(keep) == len(states) == 2 * LAYERS
        for (p0, p1), (q0, q1) in zip(states, keep):
            torch.testing.assert_close(p0[b][v0[b]], q0, rtol=RTOL, atol=RTOL)
            torch.testing.assert_close(p1[b][v1[b]], q1, rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(scores[b][v0[b]][:, v1[b]], ref_scores, rtol=RTOL,
                                   atol=RTOL * float(ref_scores.abs().max()))


@pytest.mark.parametrize("n_valid", [[(48, 48), (48, 48)], [(40, 31), (17, 48)]])
def test_matches_of_a_padded_batch_equal_per_pair_reference_runs(state_dict, n_valid):
    """matches0 of a batch with unequal valid counts against each pair's
    valid-only reference run, mapped back to the slots."""
    xy0, d0, v0, xy1, d1, v1 = _pairs(n_valid)
    lg = LightGlue(LightGlueConfig(n_layers=LAYERS), state_dict, device="cpu", dtype=torch.float32)
    got = lg.match(xy0, d0, v0, xy1, d1, v1, IMAGE)
    assert got.dtype == torch.int32 and got.shape == (2, K)
    for b in range(2):
        _, _, m = _reference(xy0, d0, v0, xy1, d1, v1, state_dict, b)
        want = torch.full((K,), -1, dtype=torch.long)
        i0, i1 = torch.nonzero(v0[b])[:, 0], torch.nonzero(v1[b])[:, 0]
        want[i0[m >= 0]] = i1[m[m >= 0]]
        assert torch.equal(got[b].long(), want)
        assert (got[b][~v0[b]] == -1).all()
    assert (got >= 0).sum() >= 10  # the pairs do match


def test_reference_match_maps_valid_keypoints_back_to_slots(state_dict):
    xy0, d0, v0, xy1, d1, v1 = _pairs([(40, 31), (17, 48)])
    net = ref.load_weights(state_dict, "cpu")
    f = lambda xy, d, v: dict(xy=xy, desc=d, valid=v)  # noqa: E731
    lg = LightGlue(LightGlueConfig(n_layers=LAYERS), state_dict, device="cpu", dtype=torch.float32)
    got = ref.match(f(xy0, d0, v0), f(xy1, d1, v1), net, CFG, IMAGE, ref.Float32())
    assert torch.equal(got, lg.match(xy0, d0, v0, xy1, d1, v1, IMAGE).long())


def test_bf16_plain_path_agrees_with_the_bf16_reference(state_dict):
    """At the configuration's precision both round to bf16 at the same
    points; where float32 sums in another order move a value across a bf16
    rounding boundary the two differ by an ulp there, and the similarity
    (thousands) inherits it, so the scores agree to a bf16 ulp of the
    matrix's largest magnitude (2^-8 of it; 2^-10 on average), and the
    matches made are the same."""
    xy0, d0, v0, xy1, d1, v1 = _pairs([(48, 48), (40, 31)])
    lg = LightGlue(LightGlueConfig(n_layers=LAYERS), state_dict, device="cpu")
    net = ref.load_weights(state_dict, "cpu")
    B = 2
    x0, r0 = lg.encode(xy0, d0, IMAGE)
    x1, r1 = lg.encode(xy1, d1, IMAGE)
    assert x0.dtype == torch.bfloat16
    for i in range(LAYERS):
        xs = lg.self_block(i, torch.cat([x0, x1]), torch.cat([v0, v1]), torch.cat([r0, r1]))
        x0, x1 = lg.cross_block(i, xs[:B], xs[B:], v0, v1)
    scores = lg.log_assignment(x0, x1, v0, v1)
    got = lg.filter(scores, v0, v1)
    for b in range(B):
        s, m = ref.forward_pair(xy0[b][v0[b]], d0[b][v0[b]], xy1[b][v1[b]], d1[b][v1[b]], net, CFG, IMAGE)
        gap = (scores[b][v0[b]][:, v1[b]] - s).abs()
        scale = float(s.abs().max())
        assert gap.max() <= 2 ** -8 * scale and gap.mean() <= 2 ** -10 * scale
        assert torch.equal(got[b][v0[b]].long() >= 0, m >= 0)


def test_rope_rotates_each_column_pair():
    """t c + rot(t) s by hand: the pair (t[2i], t[2i+1]) turns by angle u_i."""
    t = torch.tensor([1.0, 2.0, 3.0, 4.0])[None, None, None]  # (N=1, h=1, L=1, 4)
    u = torch.tensor([0.5, -1.25])
    table = torch.stack([torch.cos(u), torch.sin(u)], -1)[None, None]  # (1, 1, 2, 2)
    got = rope_rotate(t, table)[0, 0, 0]
    c0, s0, c1, s1 = math.cos(0.5), math.sin(0.5), math.cos(-1.25), math.sin(-1.25)
    want = torch.tensor([1 * c0 - 2 * s0, 2 * c0 + 1 * s0, 3 * c1 - 4 * s1, 4 * c1 + 3 * s1])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_wqkv_deinterleaves_by_head_dim_and_projection():
    """Output channel 192 h + 3 j + w of Wqkv is head h, dim j of q, k or v
    (LightGlue's unflatten(-1, (heads, -1, 3))): in the split layout it is
    column j of head h's (D, dh) kernel."""
    w = torch.arange(3 * D, dtype=torch.float32)[:, None] * 1000 + torch.arange(D, dtype=torch.float32)
    b = torch.arange(3 * D, dtype=torch.float32)
    wq, bq, wk, bk, wv, bv = split_qkv(w, b, HEADS)
    assert wq.shape == (HEADS, D, 64) and bq.shape == (HEADS, 1, 64)
    for h, j in ((0, 0), (1, 5), (3, 63)):
        for which, (wx, bx) in enumerate(((wq, bq), (wk, bk), (wv, bv))):
            c = 192 * h + 3 * j + which
            assert torch.equal(wx[h, :, j], w[c]) and bx[h, 0, j] == b[c]


def test_layer_weights_take_the_cross_blocks_qk_for_q_and_k(state_dict):
    self_w = layer_weights(state_dict, 0, "self", HEADS, torch.float32)
    cross_w = layer_weights(state_dict, 1, "cross", HEADS, torch.float32)
    assert len(self_w) == len(cross_w) == 15
    assert torch.equal(cross_w[0], cross_w[2]) and torch.equal(cross_w[1], cross_w[3])
    qk = state_dict["transformers.1.cross_attn.to_qk.weight"]
    assert torch.equal(cross_w[0][2, :, 7], qk[2 * 64 + 7])
    assert self_w[11].dtype == torch.float32 and torch.equal(self_w[11][0], torch.ones(2 * D))


@pytest.mark.parametrize("kw", [dict(depth_confidence=0.95), dict(width_confidence=0.99),
                                dict(depth_confidence=0.0), dict(num_heads=8)])
def test_config_refuses_adaptivity_and_other_head_widths(kw):
    with pytest.raises(ValueError):
        LightGlueConfig(**kw)


def test_state_dict_with_other_depth_is_refused(state_dict):
    with pytest.raises(ValueError, match="layers"):
        LightGlue(LightGlueConfig(n_layers=3), state_dict, device="cpu")

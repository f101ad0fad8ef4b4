"""The port's training losses (forest_slam_tpu_torch.train.losses) against
train/losses.py on the same seeded numpy inputs.

Tolerances: labels exact; losses within rtol 1e-5 (float32 sums in another
order). The two last-writer scatters are held to the reference on inputs
made to hit them: several corners in one cell (detector labels), and
``matching_loss``'s slot 0, which every unmatched row writes False into
after row 0 matched it. The reference's scatter applies its updates in
order on the CPU, so slot 0 then counts as unmatched; the port computes the
last writer explicitly and must agree, with the test first confirming that
the reference behaves so.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forest_slam_tpu.train import losses as J
from forest_slam_tpu_torch.train import losses as T

B, M, H, W = 3, 24, 64, 80


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _corners(rng, dup_cells=True):
    """(B, M, 2) corners, a quarter invalid; with ``dup_cells`` groups of
    corners share a cell (and some a pixel), in both orders of their
    sub-cell positions."""
    xy = rng.uniform([0.0, 0.0], [W - 0.01, H - 0.01], size=(B, M, 2)).astype(np.float32)
    if dup_cells:
        for b in range(B):
            xy[b, 1] = xy[b, 0] + np.float32(0.3)  # same pixel or its neighbour, later writer
            base = np.floor(xy[b, 5] / 8) * 8
            xy[b, 6:9] = base + rng.uniform(0, 7.99, size=(3, 2)).astype(np.float32)  # three more in cell of 5
            xy[b, 20] = xy[b, 3]  # an exact duplicate far later
    valid = rng.random((B, M)) < 0.75
    valid[:, [0, 1, 5, 6, 7, 8, 3, 20]] = True
    valid[0, 8] = False  # an invalid corner in a shared cell writes nothing
    return xy, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_detector_labels_last_writer(seed):
    rng = np.random.default_rng(seed)
    xy, valid = _corners(rng)
    ref = np.stack([np.asarray(J.detector_labels(jnp.asarray(xy[b]), jnp.asarray(valid[b]), H, W)) for b in range(B)])
    got = T.detector_labels(_t(xy), _t(valid), H, W).numpy()
    np.testing.assert_array_equal(got, ref)
    # the duplicates really collide: fewer labelled cells than valid corners
    assert (ref != 64).sum() < valid.sum()


def test_detector_labels_roundtrip():
    corners = torch.tensor([[[10.0, 12.0], [33.0, 40.0]]])
    labels = T.detector_labels(corners, torch.tensor([[True, True]]), 64, 80)[0].numpy()
    assert labels.shape == (8, 10)
    assert labels[1, 1] == (12 % 8) * 8 + (10 % 8)
    assert labels[5, 4] == (40 % 8) * 8 + (33 % 8)
    assert (labels == 64).sum() == 8 * 10 - 2


@pytest.mark.parametrize("soft", [False, True])
def test_detector_loss(soft):
    rng = np.random.default_rng(2)
    xy, valid = _corners(rng)
    logits = rng.normal(size=(B, H // 8, W // 8, 65)).astype(np.float32) * 3
    jf, tf = (J.detector_loss_soft, T.detector_loss_soft) if soft else (J.detector_loss, T.detector_loss)
    ref = float(jf(jnp.asarray(logits), jnp.asarray(xy), jnp.asarray(valid)))
    got = float(tf(_t(logits), _t(xy), _t(valid)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_detector_labels_soft():
    rng = np.random.default_rng(3)
    xy, valid = _corners(rng)
    xy[0, 2] = [W - 0.2, H - 0.5]  # clamped at the far border
    ref = np.stack([np.asarray(J.detector_labels_soft(jnp.asarray(xy[b]), jnp.asarray(valid[b]), H, W))
                    for b in range(B)])
    got = T.detector_labels_soft(_t(xy), _t(valid), H, W).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("temperature", [0.07, 0.5])
def test_descriptor_nce_loss(temperature):
    rng = np.random.default_rng(4)
    d0 = rng.normal(size=(B, M, 32)).astype(np.float32)
    d1 = d0 + 0.5 * rng.normal(size=(B, M, 32)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    valid = rng.random((B, M)) < 0.6
    valid[2] = False  # a pair with no matchable corner
    ref = float(J.descriptor_nce_loss(jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(valid), temperature))
    got = float(T.descriptor_nce_loss(_t(d0), _t(d1), _t(valid), temperature))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def _log_p(rng, K0, K1):
    lp = rng.normal(size=(B, K0 + 1, K1 + 1)).astype(np.float32)
    return lp - np.log(np.exp(lp).sum(axis=2, keepdims=True))


def test_matching_loss_slot0_last_writer():
    """Row 0 matches slot 0; later rows are unmatched (-1) and write False
    into slot 0 after it, so the reference charges slot 0 to the dustbin."""
    rng = np.random.default_rng(5)
    K0 = K1 = 12
    log_p = _log_p(rng, K0, K1)
    gt = np.full((B, K0), -1, np.int32)
    gt[:, 0] = 0
    gt[:, 2] = 3
    gt[1, 5:] = -1
    gt[2] = np.arange(K0)  # every row matched: slot 0 stays matched
    valid0 = np.ones((B, K0), bool)
    valid1 = np.ones((B, K1), bool)
    j = lambda a: jnp.asarray(a)
    ref = float(J.matching_loss(j(log_p), j(gt), j(valid0), j(valid1)))
    got = float(T.matching_loss(_t(log_p), _t(gt).long(), _t(valid0), _t(valid1)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # the reference's own behaviour, confirmed: with slot 0 counted as
    # matched (first writer wins) the loss would differ
    lp0 = log_p[0]
    row = -np.mean([lp0[i, gt[0, i] if gt[0, i] >= 0 else K1] for i in range(K0)])
    unmatched_last = np.ones(K1, bool)
    unmatched_last[3] = False  # slot 0 unmatched: a later -1 row wrote False last
    unmatched_first = unmatched_last.copy()
    unmatched_first[0] = False
    one = lambda un: row + (-lp0[K0, :K1][un]).mean()
    ref0 = float(J.matching_loss(j(log_p[:1]), j(gt[:1]), j(valid0[:1]), j(valid1[:1])))
    np.testing.assert_allclose(ref0, one(unmatched_last), rtol=1e-5)
    assert abs(ref0 - one(unmatched_first)) > 1e-3
    got0 = float(T.matching_loss(_t(log_p[:1]), _t(gt[:1]).long(), _t(valid0[:1]), _t(valid1[:1])))
    np.testing.assert_allclose(got0, ref0, rtol=1e-5)


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_matching_loss_random(seed):
    rng = np.random.default_rng(seed)
    K0, K1 = 16, 20
    log_p = _log_p(rng, K0, K1)
    gt = np.where(rng.random((B, K0)) < 0.6, rng.permutation(K1)[:K0][None].repeat(B, 0), -1).astype(np.int32)
    valid0 = rng.random((B, K0)) < 0.8
    valid1 = rng.random((B, K1)) < 0.8
    j = lambda a: jnp.asarray(a)
    ref = float(J.matching_loss(j(log_p), j(gt), j(valid0), j(valid1)))
    got = float(T.matching_loss(_t(log_p), _t(gt).long(), _t(valid0), _t(valid1)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_last_writer_ignores_write_order():
    idx = torch.tensor([[2, 0, 2, 1, 2, 0]])
    assert T.last_writer(idx, 4).tolist() == [[5, 3, 4, -1]]

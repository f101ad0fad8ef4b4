"""Losses for the learned front end (port of train/losses.py).

- ``detector_loss``: 65-way cell-classification cross-entropy on the
  SuperPoint detector head against known corner labels; ``detector_loss_soft``
  against bilinear sub-pixel targets.
- ``descriptor_nce_loss``: symmetric InfoNCE over descriptors sampled at
  ground-truth correspondences.
- ``matching_loss``: SuperGlue's negative log-likelihood of the ground-truth
  assignment (dustbins included) under the Sinkhorn couplings.

All take batched, masked fixed-shape inputs. Each divides a sum over the
batch by a count over the batch; ``total`` (default: none) maps a local
count to the count over the whole global batch, so a data-parallel rank
that holds a slice of it divides by the global count and the ranks' losses
sum to the global loss (train/trainer.py:make_sharded_train_step). Two of the reference's scatters
write one slot several times and keep the last write (XLA applies the
updates in order): a cell's label when several corners fall in it, and the
"matched" flag of set-1 slot 0, which every unmatched row writes False into.
PyTorch leaves the order of duplicate writes undefined on the card, so
:func:`last_writer` finds each slot's last writer explicitly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def last_writer(index: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size) position of the last of the (B, M) writes ``index`` that
    lands in each slot, -1 for a slot no write reaches: what a scatter that
    applies its updates in order leaves, whatever the device's order."""
    B, M = index.shape
    pos = torch.arange(M, device=index.device).expand(B, M)
    out = torch.full((B, size), -1, dtype=torch.long, device=index.device)
    return out.scatter_reduce(1, index.long(), pos, reduce="amax", include_self=True)


def detector_labels(corners: torch.Tensor, valid: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Corners (B, M, 2) -> (B, Hc, Wc) int64 labels in [0, 64]; 64 = no
    corner. Where several valid corners fall in one cell the last one wins."""
    B = corners.shape[0]
    Hc, Wc = height // 8, width // 8
    x = corners[..., 0].long().clamp(0, width - 1)  # truncation toward 0, as astype(int32)
    y = corners[..., 1].long().clamp(0, height - 1)
    cell = torch.where(valid, (y // 8) * Wc + (x // 8), torch.full_like(x, Hc * Wc))  # invalid: a dump slot
    sub = (y % 8) * 8 + (x % 8)
    last = last_writer(cell, Hc * Wc + 1)[:, :-1]
    labels = torch.where(last >= 0, sub.gather(1, last.clamp(min=0)), torch.full_like(last, 64))
    return labels.reshape(B, Hc, Wc)


def _local(count: torch.Tensor) -> torch.Tensor:
    return count


def _cell_weighted_mean(per_cell: torch.Tensor, corner: torch.Tensor, total=_local) -> torch.Tensor:
    """Mean with corner cells weighted 10x (corner cells are rare)."""
    w = torch.where(corner, 10.0, 1.0)
    return (per_cell * w).sum() / total(w.sum())


def detector_loss(logits: torch.Tensor, corners: torch.Tensor, valid: torch.Tensor, total=_local) -> torch.Tensor:
    """logits (B, Hc, Wc, 65); corners (B, M, 2); valid (B, M)."""
    _, Hc, Wc, _ = logits.shape
    labels = detector_labels(corners, valid, Hc * 8, Wc * 8)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    return _cell_weighted_mean(nll, labels != 64, total)


def detector_labels_soft(corners: torch.Tensor, valid: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Corners (B, M, 2) float -> (B, Hc, Wc, 65) soft targets: each corner's
    unit mass split bilinearly over its four pixels, per cell [pixel masses,
    leftover to the dustbin], normalised."""
    B = corners.shape[0]
    Hc, Wc = height // 8, width // 8
    x = corners[..., 0].clamp(0.0, width - 1.001)
    y = corners[..., 1].clamp(0.0, height - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    vf = valid.float()
    mass = torch.zeros((B, height * width), dtype=torch.float32, device=corners.device)
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)), (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi = (x0i + dx).clamp(max=width - 1)
        yi = (y0i + dy).clamp(max=height - 1)
        mass = mass.scatter_add(1, yi * width + xi, w * vf)
    cells = mass.reshape(B, Hc, 8, Wc, 8).permute(0, 1, 3, 2, 4).reshape(B, Hc, Wc, 64)
    dustbin = torch.clamp(1.0 - cells.sum(-1, keepdim=True), min=0.0)
    t = torch.cat([cells, dustbin], dim=-1)
    return t / torch.clamp(t.sum(-1, keepdim=True), min=1e-12)


def detector_loss_soft(logits: torch.Tensor, corners: torch.Tensor, valid: torch.Tensor,
                       total=_local) -> torch.Tensor:
    """Soft cross-entropy against :func:`detector_labels_soft`; corner cells
    weighted 10x."""
    _, Hc, Wc, _ = logits.shape
    targets = detector_labels_soft(corners, valid, Hc * 8, Wc * 8)
    ce = -(targets * F.log_softmax(logits, dim=-1)).sum(-1)
    return _cell_weighted_mean(ce, targets[..., :64].sum(-1) > 1e-6, total)


def descriptor_nce_loss(desc0: torch.Tensor, desc1: torch.Tensor, valid: torch.Tensor,
                        temperature: float = 0.07, total=_local) -> torch.Tensor:
    """Symmetric InfoNCE: desc0/desc1 (B, M, D) L2-normalised descriptors at
    corresponding points; valid (B, M)."""
    sim = torch.einsum("bmd,bnd->bmn", desc0, desc1) / temperature
    mask = valid[:, :, None] & valid[:, None, :]
    sim = torch.where(mask, sim, torch.full_like(sim, -1e9))
    diag01 = torch.diagonal(F.log_softmax(sim, dim=2), dim1=1, dim2=2)
    diag10 = torch.diagonal(F.log_softmax(sim, dim=1), dim1=1, dim2=2)
    per = -(diag01 + diag10) * 0.5
    denom = torch.clamp(total(valid.sum()), min=1)
    return torch.where(valid, per, torch.zeros_like(per)).sum() / denom


def matching_loss(log_p: torch.Tensor, gt_matches0: torch.Tensor, valid0: torch.Tensor,
                  valid1: torch.Tensor, total=_local) -> torch.Tensor:
    """NLL of the ground-truth assignment under Sinkhorn log-couplings
    (B, K0+1, K1+1); gt_matches0 (B, K0) indexes set 1, or -1 for the
    dustbin. Set-1 keypoints no row matches are charged to the dustbin row.
    The matched flags are the reference's scatter: each row writes
    ``gt >= 0`` into slot ``max(gt, 0)`` and the last write wins, so slot 0
    reads unmatched whenever a later row is unmatched."""
    _, K0p, K1p = log_p.shape
    K0, K1 = K0p - 1, K1p - 1
    has = gt_matches0 >= 0
    tgt = torch.where(has, gt_matches0, torch.full_like(gt_matches0, K1)).long()
    row_nll = -log_p[:, :K0, :].gather(2, tgt[..., None])[..., 0]
    row_nll = torch.where(valid0, row_nll, torch.zeros_like(row_nll))
    n_row = torch.clamp(total(valid0.sum()), min=1)
    idx = torch.where(has, gt_matches0, torch.zeros_like(gt_matches0))
    last = last_writer(idx, K1)
    matched1 = (last >= 0) & has.gather(1, last.clamp(min=0))
    unmatched1 = valid1 & ~matched1
    col_nll = -log_p[:, K0, :K1]
    col_nll = torch.where(unmatched1, col_nll, torch.zeros_like(col_nll))
    n_col = torch.clamp(total(unmatched1.sum()), min=1)
    return row_nll.sum() / n_row + col_nll.sum() / n_col

"""Trajectory, APE and match plots (port of eval/plots.py; host-side,
matplotlib).

The reference's offline surface is evo's plots (trajectory overlays, APE
colour maps, xyz curves, speeds) and a commented ``drawMatches`` debug view
(stereo_slam.py:248-260). This module draws the same set as PNG files:

- :func:`plot_trajectory_overlay`: top-down estimate over ground truth;
- :func:`plot_ape_colormap`: the estimate coloured by per-pose APE, with
  evo's colour bar;
- :func:`plot_xyz`: per-axis position curves;
- :func:`plot_speeds`: frame-to-frame speed curves;
- :func:`plot_matches`: side-by-side keypoints, matches and refinement
  arrows (``cli.py --debug-matches``).

matplotlib is imported inside the functions only; where it is not
installed (the card's machine, for one) they raise ImportError saying so.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the plots (cli.py plot, --debug-matches) need matplotlib, which is not installed in "
                          "this environment") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _aligned(est, gt, align: bool, with_scale: bool):
    """Associate est to gt and (optionally) Sim(3)/SE(3)-align est onto gt."""
    from forest_slam_tpu_torch.eval.alignment import umeyama_alignment
    from forest_slam_tpu_torch.eval.association import associate

    em, gm = associate(est, gt)
    P = em.positions
    if align:
        s, R, t = umeyama_alignment(em.positions, gm.positions, with_scale=with_scale)
        P = (s * (R @ em.positions.T)).T + t
    return P, gm.positions, em.timestamps


def plot_trajectory_overlay(
    path: str,
    est,
    gt,
    align: bool = True,
    with_scale: bool = True,
    label: str = "estimate",
    axes: tuple[int, int] = (0, 2),
) -> None:
    """Top-down (x/z by default) overlay of the aligned estimate over GT."""
    P, G, _ = _aligned(est, gt, align, with_scale)
    a, b = axes
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot(G[:, a], G[:, b], "-", color="0.4", lw=1.5, label="ground truth")
    ax.plot(P[:, a], P[:, b], "-", color="tab:blue", lw=1.2, label=label)
    ax.plot(G[0, a], G[0, b], "ko", ms=6)
    ax.set_xlabel("xyz"[a] + " (m)")
    ax.set_ylabel("xyz"[b] + " (m)")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title("trajectory overlay" + (" (aligned)" if align else ""))
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_ape_colormap(
    path: str,
    est,
    gt,
    align: bool = True,
    with_scale: bool = True,
    axes: tuple[int, int] = (0, 2),
) -> dict:
    """Estimated path colored by per-pose translation APE (evo's ape plot).

    Returns the APE stats dict that is also printed on the plot.
    """
    P, G, _ = _aligned(est, gt, align, with_scale)
    err = np.linalg.norm(P - G, axis=1)
    stats = {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "min": float(err.min()),
    }
    a, b = axes
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 7))
    ax.plot(G[:, a], G[:, b], "--", color="0.6", lw=1.0, label="ground truth")
    sc = ax.scatter(P[:, a], P[:, b], c=err, cmap="jet", s=6)
    fig.colorbar(sc, ax=ax, label="APE (m)")
    ax.set_xlabel("xyz"[a] + " (m)")
    ax.set_ylabel("xyz"[b] + " (m)")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(
        "APE w.r.t. translation (m)\n"
        f"rmse {stats['rmse']:.3f}  mean {stats['mean']:.3f}  "
        f"median {stats['median']:.3f}  max {stats['max']:.3f}"
    )
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return stats


def plot_xyz(path: str, est, gt, align: bool = True, with_scale: bool = True) -> None:
    """Per-axis position curves of aligned estimate vs GT over time."""
    P, G, ts = _aligned(est, gt, align, with_scale)
    t = ts - ts[0]
    plt = _mpl()
    fig, axs = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    for i, name in enumerate("xyz"):
        axs[i].plot(t, G[:, i], color="0.4", lw=1.2, label="ground truth")
        axs[i].plot(t, P[:, i], color="tab:blue", lw=1.0, label="estimate")
        axs[i].set_ylabel(f"{name} (m)")
    axs[0].legend()
    axs[2].set_xlabel("t (s)")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_matches(
    path: str,
    img0,
    img1,
    xy0,
    xy1,
    matches0=None,
    valid0=None,
    valid1=None,
    scores0=None,
    xy1_refined=None,
    max_lines: int = 200,
    title: str = "",
) -> dict:
    """Side-by-side match rendering (the reference's drawMatches surface,
    stereo_slam.py:248-260).

    ``xy0``/``xy1`` are (K, 2) keypoints for each image; ``matches0`` is
    the SuperGlue contract ((K,) index into xy1 or -1). With
    ``matches0=None``, rows of xy0/xy1 are treated as already-paired
    correspondences. ``xy1_refined`` (K0, 2), when given, draws the
    post-refinement position of each matched point in image 1 and an arrow
    from the matcher's estimate — the debugging view for localization
    error. At most ``max_lines`` match lines are drawn (highest-score
    first when ``scores0`` is given, else first-K).

    Returns {"n_kpts0", "n_kpts1", "n_matches"} so callers can log what
    was rendered.
    """
    img0 = np.asarray(img0)
    img1 = np.asarray(img1)
    xy0 = np.asarray(xy0, np.float64)
    xy1 = np.asarray(xy1, np.float64)
    H = max(img0.shape[0], img1.shape[0])
    off = img0.shape[1]
    v0 = np.ones(len(xy0), bool) if valid0 is None else np.asarray(valid0, bool)
    v1 = np.ones(len(xy1), bool) if valid1 is None else np.asarray(valid1, bool)

    if matches0 is None:
        pair_i = np.arange(len(xy0))[v0 & v1[: len(xy0)]]
        pair_j = pair_i
    else:
        m = np.asarray(matches0)
        pair_i = np.nonzero(v0 & (m >= 0))[0]
        pair_j = m[pair_i]
    if scores0 is not None and len(pair_i):
        s = np.asarray(scores0)[pair_i]
        order = np.argsort(-s)
        pair_i, pair_j = pair_i[order], pair_j[order]
    shown_i, shown_j = pair_i[:max_lines], pair_j[:max_lines]

    plt = _mpl()
    canvas = np.zeros((H, img0.shape[1] + img1.shape[1]), img0.dtype)
    canvas[: img0.shape[0], : img0.shape[1]] = img0
    canvas[: img1.shape[0], img0.shape[1] :] = img1
    fig, ax = plt.subplots(figsize=(14, 14 * H / canvas.shape[1]))
    ax.imshow(canvas, cmap="gray", vmin=0, vmax=255)
    ax.scatter(xy0[v0, 0], xy0[v0, 1], s=4, c="tab:cyan", marker="o", lw=0)
    ax.scatter(
        xy1[v1, 0] + off, xy1[v1, 1], s=4, c="tab:cyan", marker="o", lw=0
    )
    for i, j in zip(shown_i, shown_j):
        ax.plot(
            [xy0[i, 0], xy1[j, 0] + off],
            [xy0[i, 1], xy1[j, 1]],
            "-",
            color="tab:green",
            lw=0.4,
            alpha=0.7,
        )
    if xy1_refined is not None:
        r = np.asarray(xy1_refined, np.float64)
        for i, j in zip(shown_i, shown_j):
            ax.annotate(
                "",
                xy=(r[i, 0] + off, r[i, 1]),
                xytext=(xy1[j, 0] + off, xy1[j, 1]),
                arrowprops=dict(arrowstyle="->", color="tab:orange", lw=0.6),
            )
    stats = {
        "n_kpts0": int(v0.sum()),
        "n_kpts1": int(v1.sum()),
        "n_matches": int(len(pair_i)),
    }
    ax.set_title(
        (title + "  " if title else "")
        + f"kpts {stats['n_kpts0']}/{stats['n_kpts1']}  "
        f"matches {stats['n_matches']} (showing {len(shown_i)})"
    )
    ax.set_axis_off()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return stats


def plot_speeds(path: str, trajs: dict, gt=None) -> None:
    """Frame-to-frame speed curves for named trajectories (+ optional GT)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(9, 4))

    def speeds(tr):
        dt = np.diff(tr.timestamps)
        dp = np.linalg.norm(np.diff(tr.positions, axis=0), axis=1)
        m = dt > 1e-9
        return tr.timestamps[1:][m] - tr.timestamps[0], dp[m] / dt[m]

    if gt is not None:
        t, v = speeds(gt)
        ax.plot(t, v, color="0.4", lw=1.5, label="ground truth")
    for name, tr in trajs.items():
        t, v = speeds(tr)
        ax.plot(t, v, lw=1.0, label=name)
    ax.set_xlabel("t (s)")
    ax.set_ylabel("speed (m/s)")
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)

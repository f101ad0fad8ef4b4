"""The system under test: forest_slam_tpu_torch's stereo VO runner built
from a configuration file, and the calls the harness wraps around it."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def stereo_config(cfg: dict):
    """The port's StereoConfig of a configuration file."""
    from forest_slam_tpu_torch.frontend.orb import OrbConfig
    from forest_slam_tpu_torch.pipelines.stereo import StereoConfig
    from forest_slam_tpu_torch.stereo.sparse import SparseStereoConfig

    sp = cfg["sparse"]
    orb = cfg.get("orb", {})
    return StereoConfig(
        sparse=SparseStereoConfig(num_disparities=sp["num_disparities"], window=sp["window"],
                                  prefilter_cap=sp["prefilter_cap"], max_cost_ratio=sp["max_cost_ratio"],
                                  subpixel=sp["subpixel"]),
        reproj_threshold_px=cfg["reproj_threshold_px"], n_hypotheses=cfg["n_hypotheses"],
        min_points=cfg["min_points"], min_inlier_ratio=cfg["min_inlier_ratio"],
        min_inliers_absolute=cfg["min_inliers_absolute"], refine_iters=cfg["refine_iters"],
        compose_mode=cfg["compose_mode"], min_depth=cfg["min_depth"], max_depth=cfg["max_depth"],
        match_refine_radius=cfg["refine_radius"], match_refine_scales=tuple(cfg["refine_scales"]),
        orb=OrbConfig(**orb) if orb else OrbConfig(), max_match_distance=cfg.get("max_match_distance", 64),
        pnp_minimal=cfg["pnp_minimal"])


class System:
    """The port's runner over one cell's inputs, its front end built by
    ``frontend.program`` (the configuration's ``frontends/<frontend>.py``
    where not given), handed a copy of any weights drawn from the seed
    (``inputs["weights"]``). :meth:`run` runs the whole
    virtual sequence once and returns (StereoStepOut, StereoArtifacts, the
    refined observations of each pair chunk, or None where the runner did
    not call ``pair_from_slab``)."""

    def __init__(self, cfg: dict, traffic: dict, inputs: dict, root: str, device, frontend=None):
        from forest_slam_tpu_torch.core.camera import PinholeCamera, StereoRig
        from forest_slam_tpu_torch.pipelines import stereo

        from bench_port import manifest

        self.stereo = stereo
        self.cfg = stereo_config(cfg)
        H, W = traffic["height"], traffic["width"]
        cam = PinholeCamera.create(inputs["K"], None, W, H, device=device)
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = inputs["baseline"]
        self.rig = StereoRig(left=cam, right=cam, T_left_right=torch.as_tensor(T, device=device))
        if frontend is None:
            frontend = manifest.frontend(cfg["frontend"], root)
        drawn = inputs.get("weights")
        handed = inputs if drawn is None else dict(inputs, weights={k: v.clone() for k, v in drawn.items()})
        self.frontend = frontend.program(cfg, self.cfg, handed, root, device)
        self.inputs = inputs
        self.chunks = (traffic["frame_chunk"], traffic["pair_chunk"])
        self._obs = None
        inner = getattr(stereo.pair_from_slab, "__wrapped__", stereo.pair_from_slab)

        def pair_from_slab(*args, **kwargs):
            out = inner(*args, **kwargs)
            if self._obs is not None:
                self._obs.append(out.obs)
            return out

        pair_from_slab.__wrapped__ = inner
        stereo.pair_from_slab = pair_from_slab

    def close(self):
        """Put the runner's own per-pair call back (the wrapper holds this
        object, and with it the front end, alive)."""
        self.stereo.pair_from_slab = self.stereo.pair_from_slab.__wrapped__

    def run(self):
        self._obs = []
        outs, art = self.stereo.run_stereo_vo_device(
            self.inputs["left"], self.inputs["right"], self.rig, self.cfg, None, self.frontend,
            frame_batch=self.chunks[0], pair_batch=self.chunks[1], return_artifacts=True,
            gumbel=self.inputs["gumbel"], uniform=self.inputs["uniform"])
        obs, self._obs = self._obs, None
        return outs, art, (torch.cat(obs) if obs else None)

    @contextlib.contextmanager
    def phase_clocks(self, sync):
        """Replace the runner's per-frame and per-pair calls with ones that
        synchronise before and after and add their host-clock time to the
        yielded dict (seconds and counts of frames and pairs)."""
        st = self.stereo
        clocks = dict(frame_s=0.0, frames=0, pair_s=0.0, pairs=0)
        orig_f, orig_p = st.frame_features, st.pair_from_slab

        def timed(fn, key, count):
            def call(*args, **kwargs):
                sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                sync()
                clocks[key + "_s"] += time.perf_counter() - t0
                clocks[key + "s"] += count(args)
                return out
            return call

        st.frame_features = timed(orig_f, "frame", lambda a: a[0].shape[0])
        st.pair_from_slab = timed(orig_p, "pair", lambda a: a[1].shape[0])
        try:
            yield clocks
        finally:
            st.frame_features, st.pair_from_slab = orig_f, orig_p

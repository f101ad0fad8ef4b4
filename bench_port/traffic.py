"""The general traffic generator: one traffic file's parameters and a seed
make every input of a run, on the device.

Parameters: ``n_frames`` of the virtual sequence and the ``n_unique``
frames it ping-pongs over, ``height`` x ``width``, metres a frame
(``speed``), the stereo ``baseline``, ``texture_px``, the trajectory's start
drawn in ``[0, start_max)`` steps, and the runner's ``frame_chunk`` and
``pair_chunk``. The seed draws the textures, the start and the PnP draws
(Gumbel noise (M-1, n_hypotheses, K) and uniforms (M-1, K), K the front
end's keypoint budget) from one ``torch.Generator`` on the device, so one
seed gives the same inputs."""

from __future__ import annotations

import torch

from bench_port import manifest, render


def make_inputs(traffic: dict, cfg: dict, seed: int, device, frontend=None) -> dict:
    """Unique frames ``left_u``/``right_u`` (U, H, W), the virtual stacks
    ``left``/``right`` (M, H, W), ``index`` (M,), ``truth`` (M, 4, 4)
    T_world_cam, ``gumbel``, ``uniform``, the rig's ``K`` and ``baseline``.
    The PnP draws are sized by the keypoint budget of ``frontend`` (the
    configuration's front-end module, found by name where not given)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    H, W = traffic["height"], traffic["width"]
    tex = render.textures(gen, traffic["texture_px"], device)
    start = float(torch.randint(0, traffic["start_max"], (1,), generator=gen, device=device).item())
    Ts = render.trajectory(traffic["n_unique"], traffic["speed"], start, device)
    K = render.rig_matrix(H, W)
    left_u, right_u = render.render_stereo(tex, Ts, K, traffic["baseline"], H, W)
    index = torch.as_tensor(render.frame_index(traffic["n_frames"], traffic["n_unique"]), dtype=torch.long,
                            device=device)
    if frontend is None:
        frontend = manifest.frontend(cfg["frontend"])
    M, n_kp = index.shape[0], frontend.keypoints(cfg)
    gumbel = torch.rand((M - 1, cfg["n_hypotheses"], n_kp), generator=gen, device=device)
    gumbel.clamp_(min=torch.finfo(torch.float32).tiny).log_().neg_().log_().neg_()
    uniform = 1e-9 + (1.0 - 1e-9) * torch.rand((M - 1, n_kp), generator=gen, device=device)
    return dict(left_u=left_u, right_u=right_u, left=left_u[index].contiguous(), right=right_u[index].contiguous(),
                index=index, truth=Ts[index], gumbel=gumbel, uniform=uniform, K=K, baseline=traffic["baseline"],
                start=start)

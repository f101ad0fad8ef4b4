"""One run of one cell:

    python -m bench_port --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel library, the inputs from the seed, the front
end with any weights it draws from the seed, one warm-up sequence at the
cell's shapes) is ``setup_s``. The window
then runs ``run_stereo_vo_device`` on the whole virtual sequence, back to
back, each sequence synchronised at its end, until ``--seconds`` have
passed: ``pairs_per_s`` is the pairs of the sequences completed over the
window's time from its start to the end of the last one. With ``--trace 1``
the window is followed by a stretch with the phases clocked and a profiled
stretch, and the cell's per-layer metrics are printed in place of the
end-to-end ones. After the window the program is freed, the plain reference
runs on the same inputs, and the check compares them (``oracle.py``). The
last line of standard output is the result as one JSON object; the last
lines of standard error print each number of the check beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import sys
import time

from bench_port import guard, manifest, oracle

CACHE_DIR = ".bench_port_cache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    import torch

    return torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)


def _program_outputs(outs, art, obs, window_poses) -> dict:
    f = art.feats
    return dict(xy=f.xy, valid=f.valid, desc=f.desc, z=art.z, z_ok=art.z_ok, matches=art.matches, obs=obs,
                poses=outs.pose, ok=outs.ok, window_poses=window_poses)


def _control_outputs(inputs, cfg, root: str, frontend, pnp_batch: int) -> dict:
    """The control in the program's place: the reference one precision
    below the configuration's, on the same inputs."""
    from bench_port.reference import pipeline
    from bench_port.reference.common import Precision

    c = pipeline.run(_reference_inputs(inputs, root), cfg, frontend, Precision(lower=True), pnp_batch=pnp_batch)
    idx = inputs["index"]
    fr = {k: v[idx] for k, v in c["frames"].items()}
    return dict(xy=fr["xy"], valid=fr["valid"], desc=fr["desc"], z=fr["z"], z_ok=fr["z_ok"], matches=c["matches"],
                obs=c["obs"], poses=c["poses"], ok=c["ok"], window_poses=[c["poses"]])


def _reference_inputs(inputs, root: str):
    """What the reference is handed: the rendered frames, the draws, the
    rig, the weights drawn from the seed (the originals, None where the
    front end reads a file) and the checkout's root, under which it reads a
    checkpoint itself."""
    return dict(left=inputs["left_u"], right=inputs["right_u"], index=inputs["index"], gumbel=inputs["gumbel"],
                uniform=inputs["uniform"], K=inputs["K"], baseline=inputs["baseline"], weights=inputs["weights"],
                root=root)


def _accuracy(poses, ok, truth) -> str:
    """Tracked share and the translation RMSE of frames 1..M-1 against the
    synthetic truth relative to frame 0 (no alignment: both are in frame 0's
    camera)."""
    from bench_port.reference.common import mm, se3_inverse

    rel_truth = mm(se3_inverse(truth[:1]).expand(truth.shape[0] - 1, 4, 4), truth[1:])
    err = (poses[:, :3, 3] - rel_truth[:, :3, 3]).norm(dim=-1)
    return f"tracked {int(ok.sum())}/{ok.numel()}, position RMSE against the truth {float(err.pow(2).mean().sqrt())} m"


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device="cuda", t_process=None,
             program: str = "port"):
    """(result dict, check lines). ``program`` "control" puts the control
    in the program's place (no window is run)."""
    import torch

    from bench_port import roofline, trace as tracing, traffic as gen
    from bench_port.reference import pipeline

    t_process = time.time() if t_process is None else t_process
    sync = _sync(device)
    cfg, tr, fe = cell.config, cell.traffic, cell.frontend
    inputs = gen.make_inputs(tr, cfg, seed, device, fe)
    inputs["weights"] = fe.weights(cfg, cell.root, seed, device)
    sync()
    log(f"# inputs: {tr['n_frames']} frames over {tr['n_unique']} rendered at {tr['width']}x{tr['height']}, "
        f"start step {inputs['start']}, {time.time() - t_process:.2f} s since process start")
    dev_name = torch.cuda.get_device_name(torch.device(device)) if torch.device(device).type == "cuda" else "cpu"
    M = tr["n_frames"]
    metrics, dev_extra, breakdown = {}, {}, None
    if program == "control":
        prog = _control_outputs(inputs, cfg, cell.root, fe, tr["pair_chunk"])
        attempted, peak = M - 1, 0
    else:
        from bench_port.system import System

        system = System(cfg, tr, inputs, cell.root, device, fe)
        log(f"# the port and its front end loaded, {time.time() - t_process:.2f} s since process start")
        system.run()
        sync()
        setup_s = time.time() - t_process
        log(f"# set-up {setup_s:.3f} s (warm-up sequence included)")
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        rng = random.Random(seed)
        window_poses, oks, kept, ends = [], [], None, []
        t0 = time.perf_counter()
        while True:
            outs, art, obs = system.run()
            sync()
            t_end = time.perf_counter()
            ends.append(t_end)
            window_poses.append(outs.pose)
            oks.append(outs.ok)
            if rng.randrange(len(window_poses)) == 0:
                kept = (outs, art, obs, len(window_poses) - 1)
            del outs, art, obs
            if t_end - t0 >= seconds:
                break
        n_seq, window_s = len(window_poses), t_end - t0
        attempted = n_seq * (M - 1)
        each = sorted(b - a for a, b in zip([t0] + ends[:-1], ends))
        log(f"# window: {n_seq} sequences, {attempted} pairs in {window_s:.4f} s (a sequence {each[0]:.4f} to "
            f"{each[-1]:.4f} s, median {each[len(each) // 2]:.4f}); sequence {kept[3]} is checked")
        peak = int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0
        if not trace:
            metrics["pairs_per_s"] = {"value": attempted / window_s, "unit": "pairs/s"}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        else:
            n_tr = tr["trace_sequences"]
            # the clocked stretch first: a profiler window slows the host's
            # work after it in the same process
            with system.phase_clocks(sync) as clocks:
                for _ in range(n_tr):
                    system.run()
            prof = tracing.profile_sequences(system.run, n_tr, sync)
            log(f"# traced {n_tr} sequences: busy {prof['busy_s']:.4f} of {prof['window_s']:.4f} s; phases {clocks}")
            ctx = dict(config=cfg, traffic=tr, device_name=dev_name, peaks=roofline.device_peaks(dev_name),
                       window=dict(seconds=window_s, sequences=n_seq, frames=n_seq * M, pairs=attempted),
                       trace=prof, phases=clocks, inputs=inputs, roofline=roofline, frontend=fe)
            for m in cell.per_layer:
                v = manifest.reader(m["name"], cell.root)(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
            dev_extra = dict(busy_s=prof["busy_s"], window_s=prof["window_s"])
            breakdown = dict(device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
        outs, art, obs, _ = kept
        prog = _program_outputs(outs, art, obs, window_poses)
        prog["ok_all"] = torch.cat(oks)
        system.close()
        del system, outs, art, obs, kept
    for k in ("left", "right"):
        inputs.pop(k)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ok_all = prog.get("ok_all", prog["ok"])
    failed = int((~ok_all).sum())
    log(f"# program: {_accuracy(prog['poses'], prog['ok'], inputs['truth'])}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t_ref = time.time()
        ref = pipeline.run(_reference_inputs(inputs, cell.root), cfg, fe, pnp_batch=tr["pair_chunk"])
        sync()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"# reference: {_accuracy(ref['poses'], ref['ok'], inputs['truth'])}; {time.time() - t_ref:.2f} s")
    look = {}
    values = oracle.numbers(prog, ref, inputs["index"], (tr["height"], tr["width"]), cfg, fe, look)
    log(f"# look: {json.dumps(look)}")
    correct, lines = oracle.verdict(values, cell.limits)
    device_rec = dict(platform="gpu" if torch.device(device).type == "cuda" else "cpu", kind=dev_name, count=1,
                      memory_peak_bytes=peak, **dev_extra)
    result = dict(correct=bool(correct), attempted=attempted, failed=failed, metrics=metrics, device=device_rec)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": values.get(k), "limit": v} for k, v in cell.limits.items()}
    return result, lines


def main(argv, t_process=None) -> int:
    t_process = time.time() if t_process is None else t_process
    p = argparse.ArgumentParser(prog="python -m bench_port", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(manifest.ROOT, CACHE_DIR, sub)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark measures the port on a card only")
        return 2
    cell = manifest.load_cell(args.workload)
    if torch.cuda.device_count() < cell.workload["chips"]:
        log(f"{args.workload} needs {cell.workload['chips']} cards; {torch.cuda.device_count()} present")
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_process)
    found = guard.forbidden_modules()
    if found:
        log(f"the JAX stack was loaded in the measuring process: {found}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0

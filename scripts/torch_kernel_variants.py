#!/usr/bin/env python3
"""Time design variants of the select and sparse-cost kernels on one GPU.

    python3 scripts/torch_kernel_variants.py

The measurements behind the design choices that ``csrc/select.cu`` and
``csrc/sparse_cost.cu`` state in their notes, on ``chip_smoke.py``'s inputs
(device ms a call under ``torch.profiler``, ``chip_smoke.device_ms``; each
variant twice, in turns):

- ``select`` at (8, 600, 960) and (24, 256, 352) with bands of 8, 12, 16
  and 32 rows, and with ``__launch_bounds__`` asking for 4 or 6 blocks an SM;
- ``sparse_cost`` at 8 x 1024 and 24 x 512 with ``__launch_bounds__`` asking
  for 6 or 8 blocks an SM, and the committed kernel with 16-byte and with
  4-byte copies (the same images moved 4 bytes off a 16-byte boundary, which
  sends the kernel down its 4-byte path).

Each variant is a copy of the committed source with one line changed, built
with the package's nvcc flags into its own library under the gitignored
``forest_slam_tpu_torch/_build/variants/`` and called through its C entry
point with the wrapper's launch plan; every result is checked against the
plain version (select bit-exact, sparse cost exact on integer images). The
last line of its output is one JSON object with the times, each variant's
registers and spills, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KERNEL_LINE = {"select": "__global__ void __launch_bounds__(32 * kWarps)",
               "sparse_cost": "__global__ void __launch_bounds__(32 * kMaxKeypointsPerBlock)"}
BAND_LINE = "constexpr int kBandRows = 8;"
# (kernel, label, {committed line: its replacement})
VARIANTS = (
    [("select", f"{rows}-row bands", {BAND_LINE: f"constexpr int kBandRows = {rows};"}) for rows in (8, 12, 16, 32)]
    + [("select", f"at least {n} blocks an SM", {KERNEL_LINE["select"]: KERNEL_LINE["select"][:-1] + f", {n})"})
       for n in (4, 6)]
    + [("sparse_cost", "as committed", {})]
    + [("sparse_cost", f"at least {n} blocks an SM", {KERNEL_LINE["sparse_cost"]: KERNEL_LINE["sparse_cost"][:-1] + f", {n})"})
       for n in (6, 8)]
)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(out_dir):
    """One library per variant, all nvcc runs started together: [(kernel,
    label, band rows or None, CDLL, registers and spill bytes of the
    instance the paths run)]."""
    from forest_slam_tpu_torch import _build

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    for h in _build.headers():
        shutil.copy(h, out_dir)
    made = []
    for i, (kernel, label, edits) in enumerate(VARIANTS):
        src = open(os.path.join(_build.CSRC_DIR, f"{kernel}.cu")).read()
        for old, new in edits.items():
            if old not in src:
                raise RuntimeError(f"{kernel}.cu no longer holds {old!r}")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"v{i}_{kernel}.cu")
        with open(path, "w") as f:
            f.write(src)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", path[:-3] + ".so", path]
        rows = int(re.search(r"kBandRows = (\d+);", src).group(1)) if kernel == "select" else None
        made.append((kernel, label, rows, path[:-3] + ".so",
                     subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = []
    for kernel, label, rows, lib, proc in made:
        log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {label}:\n{log}")
        # ptxas -v of the instance the paths run (r = 4, w = 7)
        inst = "select_kernelILi4E" if kernel == "select" else "sparse_cost_kernelILi7E"
        tail = log[log.index(inst):]
        info = dict(registers=int(re.search(r"Used (\d+) registers", tail).group(1)),
                    spill_bytes=int(re.search(r"(\d+) bytes spill stores", tail).group(1)))
        out.append((kernel, label, rows, ctypes.CDLL(lib), info))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    from forest_slam_tpu_torch import _build
    from forest_slam_tpu_torch.frontend.select_kernel import launch_plan as select_plan
    from forest_slam_tpu_torch.frontend.select_kernel import nms_block_max_plain
    from forest_slam_tpu_torch.stereo.sparse_kernel import launch_plan as sparse_plan
    from forest_slam_tpu_torch.stereo.sparse_kernel import sparse_cost_rows, sparse_cost_rows_plain

    variants = build_variants(os.path.join(_build.BUILD_DIR, "variants"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = P(_build.stream_ptr(dev))
    out = {"device": smoke.nvidia_smi_line(), "variants": []}

    def record(kernel, label, shape, info, fn, check):
        fn()
        torch.cuda.synchronize()
        ok = check()
        ms = [smoke.device_ms(fn) for _ in range(2)]
        out["variants"].append(dict(kernel=kernel, variant=label, shape=list(shape), ok=ok, device_ms=ms, **info))
        print(f"{kernel} {label} at {tuple(shape)}: {ms[0]:.4f}, {ms[1]:.4f} ms device time a call"
              f"{'' if ok else ' DISAGREES WITH THE PLAIN VERSION'} {info}", flush=True)

    with torch.no_grad():
        for shape in (smoke.select_shapes()[0], smoke.select_shapes()[2]):
            _, _, _, heat = smoke.select_case(dev, gen, shape)
            ref = nms_block_max_plain(heat)
            B, H, W = shape
            for kernel, label, rows, lib, info in variants:
                if kernel != "select":
                    continue
                plan = select_plan(shape, 4)
                vals, idx = torch.empty_like(ref[0]), torch.empty_like(ref[1])
                args = (P(heat.data_ptr()), P(vals.data_ptr()), P(idx.data_ptr()), I(B), I(H), I(W), I(4),
                        ctypes.c_float(0.005), I(4), I(plan["col_warps"]), I(-(-H // rows)), stream)
                fn = lambda: _build.check("fs_nms_block_max", lib.fs_nms_block_max(*args))
                record(kernel, label, shape, info, fn,
                       lambda: bool(torch.equal(vals, ref[0]) and torch.equal(idx, ref[1])))
        for shape in smoke.SPARSE_SHAPES[1:]:
            _, _, _, args = smoke.sparse_case(dev, gen, shape)
            pl, pr, xi, yi, D, w = args
            ref = sparse_cost_rows_plain(*args)
            B, H, W, K = shape
            plan = sparse_plan(D, w)
            for kernel, label, rows, lib, info in variants:
                if kernel != "sparse_cost":
                    continue
                cost = torch.empty_like(ref)
                cargs = (P(pl.data_ptr()), P(pr.data_ptr()), P(xi.data_ptr()), P(yi.data_ptr()), P(cost.data_ptr()),
                         I(B), I(K), I(H), I(W), I(D), I(w), I(plan["keypoints_per_block"]), I(plan["smem_bytes"]),
                         stream)
                fn = lambda: _build.check("fs_sparse_cost", lib.fs_sparse_cost(*cargs))
                record(kernel, label, shape, info, fn, lambda: bool(torch.equal(cost, ref)))
            # the committed kernel's 4-byte path: the same images 4 bytes off a 16-byte boundary
            off = []
            for t in (pl, pr):
                buf = torch.empty(t.numel() + 4, device=dev)
                off.append(buf[1:1 + t.numel()].view(t.shape))
                off[-1].copy_(t)
            assert off[0].data_ptr() % 16 == 4 and off[0].is_contiguous()
            got = {}
            record("sparse_cost", "4-byte copies (images off 16 bytes)", shape, {},
                   lambda: got.update(c=sparse_cost_rows(off[0], off[1], xi, yi, D, w)),
                   lambda: bool(torch.equal(got["c"], ref)))
    ok = all(v["ok"] for v in out["variants"])
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Start n ranks and run one function on each (the process set-up of the
JAX package's multichip dry run and of its tests' virtual devices).

``run(fn, n, device, *args)`` spawns n processes: gloo ranks on the CPU
(one torch thread each) or one nccl rank per card, all joined through a
``FileStore`` in a temporary directory (no TCP port, so concurrent runs
cannot clash). Each rank calls ``fn(*args)`` with its default process group
up, and rank 0's return value comes back. ``fn`` must be importable from a
module that imports no JAX: each rank imports it afresh. The function and
its arguments travel through a file, not the spawn pipe, whose writes
would block until each rank had started and so start the ranks one by one.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from forest_slam_tpu_torch.parallel.mesh import BACKENDS, _device_type

TIMEOUT_S = 600  # a collective that waits longer raises instead of hanging


def _rank_main(rank: int, n: int, kind: str, store_dir: str) -> None:
    with open(os.path.join(store_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    if kind == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(store_dir, "store"), n)
    dist.init_process_group(BACKENDS[kind], store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(store_dir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(fn, n: int, device="cuda", *args):
    """``fn(*args)`` on n ranks over ``device`` ('cpu': gloo, 'cuda': nccl,
    one card a rank); rank 0's result. A rank that raises makes this raise."""
    kind = _device_type(device)
    if kind == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"{n} nccl ranks asked for, {torch.cuda.device_count()} cards visible")
    with tempfile.TemporaryDirectory(prefix="fs_ranks_") as store_dir:
        with open(os.path.join(store_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        mp.start_processes(_rank_main, args=(n, kind, store_dir), nprocs=n, join=True, start_method="spawn")
        with open(os.path.join(store_dir, "result.pkl"), "rb") as f:
            return pickle.load(f)

"""Start the ranks of a mesh (`parallel/mesh.py`) and run one function on
each.

    launch(train, 2, cfg, device="cpu")     # two gloo ranks on the CPU

``n`` > 1 joins the group that `torchrun` made where its environment is set
(RANK and WORLD_SIZE): the caller is one of its ranks.  Otherwise it starts
``n`` processes with `torch.multiprocessing` ('spawn'), which meet through
a file store in a fresh directory (no TCP port), and returns rank 0's
value.  If a rank raises, the launcher stops the others and raises with
that rank's traceback; past ``timeout_s`` it kills them all and raises.
The backend is NCCL where each rank owns a GPU ("cuda"), gloo on the CPU
and where the ranks share one device ("cuda:0": NCCL refuses two ranks on
one GPU).  On CUDA with fewer visible GPUs than the ranks on this host
(``n``, or torchrun's LOCAL_WORLD_SIZE across several hosts) it raises,
naming both counts: it never shrinks the mesh, and never moves to the CPU.
"""
from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = timedelta(seconds=120)     # every collective's limit: a lost rank fails the others


def backend_for(device) -> str:
    """NCCL where each rank owns a GPU, gloo otherwise."""
    device = torch.device("cuda" if device is None else device)
    return "nccl" if device.type == "cuda" and device.index is None else "gloo"


def check_devices(n: int, device, local: int | None = None) -> None:
    """Raise where the ``local`` ranks of this host (all ``n`` unless
    given: torchrun's LOCAL_WORLD_SIZE) that each own a GPU find fewer
    GPUs."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    have = torch.cuda.device_count()
    local = n if local is None else local
    if device.index is None and have < local:
        who = f"--mesh {n} needs" if local == n else \
            f"--mesh {n}: the {local} ranks on this host need"
        raise RuntimeError(f"{who} {local} CUDA devices, one per rank; {have} visible")
    if device.index is not None and device.index >= have:
        raise RuntimeError(f"{device}: {have} CUDA devices visible")


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_main(rank, n, backend, workdir, threads, fn, args, kwargs):
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    torch.set_num_threads(threads)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "store"),
                                world_size=n, rank=rank, timeout=TIMEOUT)
        try:
            out = fn(*args, **kwargs)
        finally:
            # the error is written before the group closes, so that a rank's
            # own failure is on disk before the ones it causes in the others
            if sys.exc_info()[0] is not None:
                _write_error(workdir, rank)
            dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(workdir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        if not os.path.exists(os.path.join(workdir, f"error{rank}.txt")):
            _write_error(workdir, rank)
        raise


def _write_error(workdir: str, rank: int) -> None:
    with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
        f.write(traceback.format_exc())


def launch(fn, n: int, *args, device=None, timeout_s: float | None = None, **kwargs):
    """``fn(*args, device=device, **kwargs)`` on each of ``n`` ranks;
    returns rank 0's value.  ``n`` <= 1 calls it here with no group.  A
    spawned rank takes this process's CPU threads divided among the ranks,
    and the ranks meet in a directory made under the system's temporary
    directory (TMPDIR)."""
    kwargs = dict(kwargs, device=device)
    if n <= 1:
        return fn(*args, **kwargs)
    if _under_torchrun():
        size = int(os.environ["WORLD_SIZE"])
        if size != n:
            raise RuntimeError(f"--mesh {n}: torchrun started {size} ranks")
        check_devices(n, device, int(os.environ.get("LOCAL_WORLD_SIZE", n)))
        if not dist.is_initialized():
            backend = backend_for(device)
            if backend == "nccl":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
        return fn(*args, **kwargs)
    check_devices(n, device)
    threads = max(torch.get_num_threads() // n, 1)
    tmp = tempfile.mkdtemp(prefix="r3d_mesh_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, n, backend_for(device), tmp, threads,
                                                  fn, args, kwargs))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(tmp, failed, n))
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks still running after {timeout_s} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(_failure(tmp, failed, n))
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def _failure(workdir: str, failed, n: int) -> str:
    """The tracebacks of the failed ranks and of any rank that has written
    one, the first written first: a rank's error makes the others fail in
    their next collective."""
    def written(rank):
        path = os.path.join(workdir, f"error{rank}.txt")
        return os.stat(path).st_mtime_ns if os.path.exists(path) else float("inf")
    ranks = set(failed) | {r for r in range(n) if written(r) < float("inf")}
    parts = []
    for rank in sorted(ranks, key=written):
        path = os.path.join(workdir, f"error{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                text = f.read()
        else:
            text = "(no traceback: killed, or exited without one)\n"
        parts.append(f"rank {rank} of {n} failed:\n{text}")
    return "".join(parts)

"""Run a function on N ranks, one process each (``--n_devices N``).

The reference runs its decomposition under ``mpiexec -n N``; the port
spawns the ranks itself with ``torch.multiprocessing`` (start method
``spawn``).  Rank r runs on ``cuda:r`` with NCCL, or on the CPU with gloo;
two ranks can share one card (gloo) only when the caller asks for it
(``share_device``, for a smoke test on a one-card machine; NCCL refuses two
ranks on one device).  The ranks meet through a file in a fresh temporary
directory and report their results to the launching process.  A failure of
any rank ends the others and raises in the launcher; so does ``timeout``.
Only rank 0 writes to standard output.
"""

import os
import pickle
import queue
import shutil
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .comm import Comm

__all__ = ["run_ranks"]


def _rank_main(rank, n, backend, device_kind, share_device, init_file, threads, fn, args,
               results):
    if rank > 0:
        sys.stdout = open(os.devnull, "w")
    torch.set_num_threads(threads)
    if device_kind == "cuda":
        device = torch.device("cuda", 0 if share_device else rank)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=n)
    comm = Comm(rank, n)
    comm.barrier()
    out = fn(comm, device, *args)
    # plain pickle bytes: a tensor put on the queue as it is would travel as
    # a shared-memory handle that dies with this process
    results.put((rank, pickle.dumps(out)))
    comm.barrier()
    dist.destroy_process_group()


def run_ranks(fn, n, args=(), device="cuda", share_device=False, timeout=None,
              rendezvous_dir=None):
    """Run ``fn(comm, device, *args)`` on ``n`` ranks; returns the ranks'
    return values in rank order.

    :arg fn: a module-level function (it is pickled to the ranks)
    :arg device: "cuda" (rank r on cuda:r, NCCL) or "cpu" (gloo)
    :arg share_device: all ranks on cuda:0 through gloo (a smoke test's
        one-card run; the CLI never shares a card)
    :arg timeout: seconds after which the ranks are ended and TimeoutError
        raised
    :arg rendezvous_dir: where the ranks' rendezvous file is made (default:
        a new temporary directory)
    """
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is False; "
                             "run on a CUDA card or pass --device cpu")
        visible = torch.cuda.device_count()
        if not share_device and visible < n:
            raise RuntimeError(f"n_devices={n} but only {visible} CUDA devices are visible")
        from .. import kernels

        kernels.build_all()  # once here, not once per rank
        backend = "gloo" if share_device else "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    tmp = tempfile.mkdtemp(prefix="iehdg-ranks-", dir=rendezvous_dir)
    results = mp.get_context("spawn").Queue()
    threads = max(1, torch.get_num_threads() // n)  # the launcher's threads, shared
    ctx = mp.spawn(_rank_main, nprocs=n, join=False, args=(
        n, backend, device, share_device, os.path.join(tmp, "rendezvous"), threads, fn, args,
        results))
    out = {}
    t0 = time.monotonic()
    try:
        while len(out) < n or not ctx.join(timeout=0.1):
            try:
                rank, value = results.get(timeout=0.1)
                out[rank] = pickle.loads(value)
            except queue.Empty:
                ctx.join(timeout=0)  # raises when a rank failed, ending the others
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"{n} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n)]

"""Multi-process gloo groups for the port's distributed tests (CPU).

``run_ranks(n, fn, *args)`` spawns ``n`` processes, joins them into one gloo
group through a ``FileStore`` in a fresh temporary directory (no TCP port,
so parallel test workers never collide), calls ``fn(rank, *args)`` in each
and returns the ranks' results in rank order. A rank that raises fails the
call with its traceback; a group that does not finish within ``timeout``
seconds is killed and fails the call, so a hung collective fails its test
rather than the suite. This module imports no JAX: the children import it
to find ``fn``.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import traceback


def _child(rank, world, store_path, fn, args, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        try:
            out.put((rank, True, fn(rank, *args)))
        finally:
            if dist.is_initialized():     # fn may have ended the group
                dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def run_ranks(n: int, fn, *args, timeout: float = 120.0):
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, args=(r, n, store, fn, args, out),
                             daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, []
        try:
            for _ in range(n):
                rank, ok, value = out.get(timeout=timeout)
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
        except queue.Empty:
            errors.append(f"the group of {n} ranks did not finish in "
                          f"{timeout} s")
        finally:
            for p in procs:
                p.join(timeout=5 if not errors else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(n)]

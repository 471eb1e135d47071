"""Run a function on every rank of a local world of processes.

JAX drives all of its devices from one process; torch.distributed needs a
process a rank. `run(world, fn, *args)` starts `world` processes with the
spawn start method (never fork: the caller may hold threads, such as
JAX's), each of which joins a default process group over a FileStore in
a fresh temporary directory (no fixed port, so concurrent worlds on one
host never collide), calls `fn(make_mesh(backend=..., device=...),
*args)` and sends its result back with every tensor in it as a numpy
array. The results come back as a list in rank order. If a rank raises
or dies, the others are stopped and `run` raises with that rank's
traceback.

`fn` must be a module-level function of this package: a spawned process
imports the module that holds it, and the card's host has no JAX.
`run_cases` is such a function: it runs a list of dist calls on numpy
inputs, for tests that hold the port against the JAX package.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from multiprocessing.connection import wait

from lsdradixsort_tpu_torch.core.convert import to_numpy
from lsdradixsort_tpu_torch.parallel.mesh import make_mesh, shard_1d

TIMEOUT_S = 900     # a world that has not finished by then is stopped


def _to_host(x):
    """x with every tensor in it (in tuples, lists, dicts) as numpy."""
    if isinstance(x, torch.Tensor):
        if x.element_size() == 4:
            return to_numpy(x)
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _child(rank, world, store_path, backend, device, fn, args, conn):
    try:
        if torch.device(device or "cuda").type == "cpu":
            torch.set_num_threads(1)
        os.environ.setdefault("LOCAL_RANK", str(rank))
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            out = fn(make_mesh(backend=backend, device=device), *args)
            conn.send((True, _to_host(out)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — sent to the parent, which raises
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        conn.close()


def run(world: int, fn, *args, backend: str = "nccl", device=None) -> list:
    """fn(mesh, *args) on each of `world` new processes; their results in
    rank order. backend and device as in `make_mesh`."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="lsd_world_") as tmp:
        store_path = os.path.join(tmp, "store")
        procs, conns = [], []
        for rank in range(world):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_child, daemon=True, args=(
                rank, world, store_path, backend, device, fn, args, send))
            p.start()
            send.close()
            procs.append(p)
            conns.append(recv)
        try:
            return _collect(procs, conns)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect(procs, conns) -> list:
    results: dict[int, object] = {}
    deadline = time.monotonic() + TIMEOUT_S
    while len(results) < len(procs):
        left = deadline - time.monotonic()
        waiting = {conns[r]: r for r in range(len(procs)) if r not in results}
        if left <= 0:
            raise TimeoutError(f"ranks {sorted(waiting.values())} did not "
                               f"finish in {TIMEOUT_S} s")
        ready = wait(list(waiting), timeout=left)
        for c in ready:
            rank = waiting[c]
            try:
                ok, payload = c.recv()
            except EOFError:
                procs[rank].join(timeout=5)
                raise RuntimeError(f"rank {rank} died (exit code "
                                   f"{procs[rank].exitcode})") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
    return [results[r] for r in range(len(procs))]


def run_cases(mesh, cases) -> list:
    """Rank body of `run` for tests: each case is (fn, args, kwargs,
    n_devices). Every numpy array in args is sharded over a mesh of the
    first n_devices ranks (None: all; its subgroups are made once, in the
    order the cases name them), and fn(*args, mesh=..., **kwargs) runs on
    its members; other ranks return None for the case."""
    meshes = {None: mesh}
    out = []
    for fn, args, kwargs, n_devices in cases:
        if n_devices not in meshes:
            meshes[n_devices] = make_mesh(
                n_devices, backend=dist.get_backend(), device=mesh.device)
        m = meshes[n_devices]
        if not m.member:
            out.append(None)
            continue
        a = [shard_1d(x, m) if isinstance(x, np.ndarray) else x
             for x in args]
        out.append(_to_host(fn(*a, mesh=m, **kwargs)))
    return out

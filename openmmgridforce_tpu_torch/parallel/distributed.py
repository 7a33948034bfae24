"""Multi-process data parallelism on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/distributed.py``. JAX runs
one controller per host that sees every device of every process; PyTorch
runs one process per device. So here every rank:

  * joins the default process group (:func:`initialize`), with the
    backend named or following from the device: NCCL on CUDA, gloo on
    the host. Several ranks on ONE card need gloo (NCCL refuses two ranks
    on one GPU);
  * holds only its own replicas: the ensemble is split over the ``dp``
    axis of a :class:`~.mesh.Mesh`, each rank feeds its rows
    (:func:`distribute_replicas`) and reads back its rows
    (:func:`local_shard`), so poses never cross the wire;
  * runs the MD loop with zero collectives (:func:`make_distributed_screen`);
    cross-replica reductions (:func:`top_k_poses`) are one all-gather of
    [R] energies and one of the k winners' poses.

:func:`launch` starts the ranks of one machine from one process (the tests,
``chip_smoke.py`` and ``examples/bpmf_sampler_torch.py`` use it); under
``torchrun`` each process calls :func:`initialize` with no arguments
instead.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import Mesh
from .replicas import replica_mesh, replica_noise

# seconds a collective may wait for its peers before the rank fails
COLLECTIVE_TIMEOUT = 600


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device=None) -> torch.device:
    """Join the default process group; returns this rank's device.

    With ``init_method`` None the rendezvous, world size and rank come from
    ``torchrun``'s environment (``env://``: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). ``device`` None is the CUDA card of LOCAL_RANK (the
    rank itself without torchrun); ``device="cpu"`` runs the rank on the
    host. ``backend`` None is NCCL for a CUDA device and gloo for the host;
    several ranks on one card pass ``backend="gloo"``.
    """
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    if world_size is None or rank is None:
        raise ValueError("initialize needs world_size and rank with an "
                         "init_method")
    if device is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = f"cuda:{local % torch.cuda.device_count()}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT), **kwargs)
    return device


# the 1-D mesh of every rank (JAX's spans the devices of every process;
# here a rank is a process)
global_replica_mesh = replica_mesh


# ----------------------------------------------------------------------
# The local launcher
# ----------------------------------------------------------------------

# seconds the parent waits, after the last rank's result, for every rank
# to tear its group down and exit
STOP_TIMEOUT = 60.0


class Launched(list):
    """The ranks' results in rank order, with ``stages``: for each rank the
    seconds of its launch by stage (``launch``'s docstring)."""

    stages: list


def _rank_main(work, rank, world_size, init_method, backend, device,
               results):
    # stage stamps on the monotonic clock, which every process of a Linux
    # host shares. The result (or the traceback) is posted before the
    # group is torn down, which may wait for peers that a failure left
    # behind; the stamps follow once the group is gone.
    stamps = {"started": time.monotonic()}
    try:
        with open(work, "rb") as f:
            fn, args = pickle.load(f)
        if torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // world_size))
        dev = initialize(init_method, world_size, rank, backend, device)
        stamps["initialized"] = time.monotonic()
        out = fn(dev, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stamps["worked"] = time.monotonic()
        payload = pickle.dumps(_map_tree(
            lambda x: x.detach().cpu() if isinstance(x, torch.Tensor)
            else x, out))
        stamps["result_bytes"] = len(payload)
        results.put(("result", rank, True, payload))
        stamps["posted"] = time.monotonic()
    except BaseException:
        results.put(("result", rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        stamps["destroyed"] = time.monotonic()
        results.put(("stopped", rank, stamps))


def _stage_seconds(t0, stamps, exited):
    """A rank's launch by stage, in seconds: spawn (process start and the
    imports of ``fn``'s module), initialize, work (``fn`` and a device
    sync), post (pickling the result and the pipe), destroy (the process
    group torn down), exit (the process ended, as the parent saw it)."""
    order = (("spawn", "started"), ("initialize", "initialized"),
             ("work", "worked"), ("post", "posted"),
             ("destroy", "destroyed"), ("exit", "exited"))
    stamps = dict(stamps, exited=exited)
    out, last = {}, t0
    for name, key in order:
        if stamps.get(key) is None:
            break
        out[name] = stamps[key] - last
        last = stamps[key]
    out["total"] = last - t0
    if "result_bytes" in stamps:
        out["result_bytes"] = stamps["result_bytes"]
    return out


def launch(fn, world_size: int, args=(), *, backend: str | None = None,
           device=None, timeout: float = 1800.0) -> Launched:
    """Run ``fn(device, *args)`` on ``world_size`` ranks started on this
    machine; returns the ranks' results in rank order (tensors on the
    host), as a list whose ``stages`` holds each rank's seconds by stage
    (spawn, initialize, work, post, destroy, exit, total; and the
    result's pickled bytes).

    Each rank is a process started by ``spawn``: ``fn`` and ``args`` are
    pickled, so ``fn`` is a module-level function whose module the ranks
    can import. They go to the ranks through a file in a temporary
    directory, not through the spawn pipe: a start blocks until its child
    has read what the pipe holds past its buffer, which the child does
    only after its imports, so large arguments would start the ranks one
    after another. The ranks meet through a file in the same directory.
    ``device`` None puts rank r on CUDA card r % device_count (NCCL), or
    all ranks on one card with ``backend="gloo"``; ``device="cpu"`` runs
    them on the host (gloo). A rank that raises or dies fails the launch
    with its traceback, after the other ranks are stopped; so does a rank
    that exits with a non-zero code after posting its result, or is still
    running ``STOP_TIMEOUT`` seconds after the last result, with its
    stages in the message.
    """
    if device is None:
        resolve_device(None)            # raises without a card
        n = torch.cuda.device_count()
        devices = ([f"cuda:{r % n}" for r in range(world_size)]
                   if backend in (None, "nccl") else ["cuda:0"] * world_size)
    else:
        devices = [str(device)] * world_size
    if backend in (None, "nccl") and len(set(devices)) < world_size and \
            devices[0] != "cpu":
        raise ValueError(f"{world_size} NCCL ranks need {world_size} cards; "
                         f"pass backend='gloo' for several ranks on one")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    rendezvous = tempfile.mkdtemp(prefix="omgf_rendezvous_")
    init_method = f"file://{os.path.join(rendezvous, 'store')}"
    work = os.path.join(rendezvous, "work.pkl")
    procs = [ctx.Process(target=_rank_main,
                         args=(work, r, world_size, init_method, backend,
                               devices[r], results),
                         daemon=True) for r in range(world_size)]
    out, failures, stamps, exited = {}, {}, {}, {}

    def receive():
        msg = results.get()
        if msg[0] == "stopped":
            stamps[msg[1]] = msg[2]
        elif msg[2]:
            out[msg[1]] = pickle.loads(msg[3])
        else:
            failures[msg[1]] = msg[3]

    def stages(r):
        return _stage_seconds(t0, stamps.get(r, {}), exited.get(r))

    t0 = time.monotonic()
    try:
        with open(work, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        for p in procs:
            p.start()
        deadline = t0 + timeout
        while len(out) < world_size and not failures:
            if not results.empty():
                receive()
                continue
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in out]
            if dead:
                time.sleep(0.5)            # a last message may be in flight
                while not results.empty():
                    receive()
                for r in dead:
                    if r not in out and r not in failures:
                        failures[r] = (f"rank {r} exited with code "
                                       f"{procs[r].exitcode} and no result")
                continue
            if time.monotonic() > deadline:
                failures[-1] = f"the launch took more than {timeout} s"
                break
            time.sleep(0.01)
        # every rank posted: each must now stop, and stop cleanly
        stop_by = time.monotonic() + STOP_TIMEOUT
        while not failures and len(exited) < world_size:
            while not results.empty():
                receive()
            for r, p in enumerate(procs):
                if r not in exited and p.exitcode is not None:
                    exited[r] = time.monotonic()
            if time.monotonic() > stop_by:
                break
            time.sleep(0.01)
        while not results.empty():
            receive()
        if not failures:
            for r, p in enumerate(procs):
                if r not in exited:
                    failures[r] = (f"rank {r} is still running "
                                   f"{STOP_TIMEOUT} s after the last "
                                   f"result; stages {stages(r)}")
                elif p.exitcode != 0:
                    failures[r] = (f"rank {r} exited with code "
                                   f"{p.exitcode} after posting its "
                                   f"result; stages {stages(r)}")
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(rendezvous, ignore_errors=True)
    if failures:
        raise RuntimeError("a rank failed:\n" + "\n".join(
            f"--- rank {r} ---\n{msg}" for r, msg in sorted(failures.items())))
    launched = Launched(out[r] for r in range(world_size))
    launched.stages = [stages(r) for r in range(world_size)]
    return launched


# ----------------------------------------------------------------------
# Replicas over the dp axis
# ----------------------------------------------------------------------

def distribute_replicas(mesh: Mesh, local_tree, axis_name: str = "dp"):
    """This rank's sub-batch (leading axis = its replicas) on its device.
    Every rank must hold the same number of replicas (global replicas /
    axis size): checked with one all-gather of the counts."""
    leaves = []

    def put(x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            t = torch.as_tensor(x).to(mesh.device)
            leaves.append(t)
            return t
        return x

    tree = _map_tree(put, local_tree)
    if leaves:
        n = torch.tensor([leaves[0].shape[0]], device=mesh.device)
        counts = mesh.all_gather(n, axis_name)
        if bool((counts != counts[0]).any()):
            raise ValueError(f"the ranks hold {counts.tolist()} replicas; "
                             f"each must hold the same number")
    return tree


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tree(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` (dataclasses such as System and
    GridBinding, lists, tuples, dicts) replaced by rank 0's, on this
    rank's device: one broadcast a tensor over the default group. Every
    rank passes a tree of one structure and shapes."""
    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        t = x.to(mesh.device).clone()
        wire = t.cpu() if mesh.host_staged else t
        dist.broadcast(wire, 0)
        return t.copy_(wire) if wire is not t else t

    return _map_tree(bcast, tree)


def local_shard(x) -> np.ndarray:
    """This rank's rows of a dp-split tensor, as a host copy."""
    return x.detach().cpu().numpy()


def make_distributed_screen(mesh: Mesh, n_steps: int, dt: float,
                            friction: float, axis_name: str = "dp"):
    """Distributed docking-screen runner: advance this rank's replicas by
    ``n_steps`` of Langevin MD and return (final states, energies [R_local]).

    ``run(states, system, grids, temperatures, noise=None)``: ``states``
    are this rank's rows, ``temperatures`` a number or its rows [R_local],
    ``noise`` its rows [n_steps, R_local, N, 3], or None: the ensemble's
    noise drawn from the states' generator (seeded alike on every rank)
    by ``replicas.replica_noise``, so the screen does not depend on the
    layout. Zero collectives: each rank's segment is ``make_md_runner``'s,
    recorded as CUDA graphs on the card.
    """
    from ..mm.system import energy_and_forces, make_md_runner

    md = make_md_runner(n_steps, dt, friction, device=mesh.device)

    def run(states, system, grids, temperatures, noise=None):
        x = states.positions
        if noise is None:
            noise = replica_noise(states.generator, n_steps, x.shape,
                                  x.dtype, mesh, axis_name,
                                  blocks=x.is_cuda)
        out = md(states, system, grids, temperatures, noise=noise)
        return out, energy_and_forces(system, grids, out.positions)[0]

    return run


def top_k_poses(mesh: Mesh, energies, positions, k: int,
                axis_name: str = "dp"):
    """The ``k`` lowest energies of the whole ensemble and their poses,
    on every rank: one all-gather of the [R_local] energies (bytes, not
    poses), then one of the winners' poses, each rank sending those of
    its rows. Returns (energies [k], positions [k, N, 3])."""
    every = mesh.all_gather(energies, axis_name)
    neg, idx = torch.topk(-every, k)
    per = energies.shape[0]
    mine = idx // per == mesh.index(axis_name)
    winners = torch.zeros((k,) + tuple(positions.shape[1:]),
                          dtype=positions.dtype, device=positions.device)
    winners[mine] = positions[idx[mine] % per]
    mesh.all_reduce(winners, axis_name)
    return -neg, winners

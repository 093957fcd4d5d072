"""The tensor-parallel serving mesh (port of `repro.launch.mesh`'s
`make_serving_mesh`) and a launcher that starts its rank processes.

The reference shard-maps one program over a (data=1, model=N) device
mesh. The port runs one process per rank instead, each holding its slice
of the weights and the KV pool, joined by a `torch.distributed` process
group that the layer boundaries all-reduce over (`runtime.shardctx`).
`make_serving_mesh` is called inside a rank process and returns that
process's view of the mesh: the group, its rank, the world size and its
device.

Devices and backends are the caller's, never chosen behind its back:

  * devices=None: cuda:0 ... cuda:N-1, one rank a card, over NCCL; it
    raises the reference's "serving mesh needs N devices, have M" with
    fewer cards;
  * devices=["cpu"] * N: the CPU, over gloo;
  * devices=["cuda:0"] * N, backend="gloo": N ranks sharing one card
    (NCCL refuses two ranks on one device); gloo reduces CUDA tensors
    through the host, so such an engine runs its steps eagerly.

N == 1 is legal, as in the reference: the same path with an all-reduce
over one rank. Called in a process with no process group, it makes a
group of one over an in-process store (no file, no network); N > 1 needs
the group that `spawn` (or another launcher) made.

`spawn(fn, n, *args)` starts N rank processes from one command (the
`spawn` start method, as CUDA needs), joins them through a `FileStore`
in a temporary directory (no TCP port, no network), calls `fn(mesh,
*args)` in each and returns rank 0's result. The arguments and the
result travel through files written with `torch.save` in that
directory, so large weights need no shared memory.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """One rank's view of a (data=1, model=size) serving mesh."""

    group: object               # the process group the ranks all-reduce over
    rank: int
    size: int
    device: torch.device
    backend: str                # "nccl" or "gloo"


def resolve_devices(model: int, devices=None, backend=None):
    """(the N devices, the backend) of a mesh of `model` ranks, or the
    reference's errors (see the module's docstring)."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < model:
            raise ValueError(
                f"serving mesh needs {model} devices, have {have}: pass "
                f"devices=['cpu'] * {model} to run the ranks on the CPU "
                f"(gloo), or devices=['cuda:0'] * {model} with "
                f"backend='gloo' to share one card")
        devices = [f"cuda:{i}" for i in range(model)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < model:
        raise ValueError(f"serving mesh needs {model} devices, have "
                         f"{len(devices)}")
    devices = devices[:model]
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a serving mesh's devices are all cuda or all "
                         f"cpu, got {[str(d) for d in devices]}")
    if backend is None:
        backend = "nccl" if kinds == {"cuda"} else "gloo"
    if backend == "nccl":
        if kinds != {"cuda"}:
            raise ValueError("backend 'nccl' reduces CUDA tensors: the "
                             "devices must be cuda devices")
        if len({(d.type, d.index) for d in devices}) < model:
            raise ValueError("NCCL takes one rank a card: ranks sharing a "
                             "card need backend='gloo'")
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    return devices, backend


def make_serving_mesh(model: int, *, devices=None, backend=None
                      ) -> ServingMesh:
    """This process's rank of a (data=1, model=`model`) serving mesh (see
    the module's docstring)."""
    devices, backend = resolve_devices(model, devices, backend)
    if not dist.is_initialized():
        if model != 1:
            raise RuntimeError(
                f"a serving mesh of {model} ranks needs a process group of "
                f"{model} ranks: start them with "
                f"repro_torch.launch.mesh.spawn")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != model:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, the mesh {model}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {backend!r}")
    rank = dist.get_rank()
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return ServingMesh(dist.group.WORLD, rank, model, device, backend)


def spawn(fn, n: int, *args, devices=None, backend=None,
          timeout: float = 600.0):
    """Run `fn(mesh, *args)` in each of `n` rank processes of one serving
    mesh and return rank 0's result.

    `fn` must be importable (pickled by reference); `args` and the result
    are saved with `torch.save`. Each rank runs with this
    process's intra-op thread count. Every rank is killed once `timeout`
    seconds have passed, or as soon as any rank fails, and the call
    raises: a rank that hangs in a collective cannot hang the caller."""
    import multiprocessing

    devices, backend = resolve_devices(n, devices, backend)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="serving-mesh-") as tmp:
        torch.save((fn, args), os.path.join(tmp, "args.pt"))
        spec = ([str(d) for d in devices], backend, timeout,
                torch.get_num_threads())
        procs = [ctx.Process(target=_rank_main, args=(rank, n, tmp, spec))
                 for rank in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if (time.monotonic() > deadline
                        or any(p.exitcode not in (None, 0) for p in procs)):
                    break
                time.sleep(0.05)
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
            for p in procs:
                p.join()
        errors = []
        for rank in range(n):
            path = os.path.join(tmp, f"error-{rank}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {rank}:\n{f.read()}")
        if errors:
            raise RuntimeError("a serving-mesh rank failed:\n"
                               + "\n".join(errors))
        if hung:
            raise TimeoutError(f"{len(hung)} of {n} ranks still ran after "
                               f"{timeout} s (or after another rank died) "
                               f"and were killed")
        bad = [rank for rank, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"serving-mesh ranks {bad} exited with "
                               f"{[procs[r].exitcode for r in bad]}")
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)


def _rank_main(rank: int, n: int, tmp: str, spec) -> None:
    """One rank process of `spawn`: join the group, make the mesh, run the
    function; rank 0 saves its result. A failure is written to
    error-<rank>.txt and ends the process with exit code 1.

    The ranks meet at a barrier before any of them tears its group down,
    and the process ends with `os._exit` once its group is destroyed: a
    gloo group destroyed during the interpreter's own shutdown sometimes
    aborted the process ("terminate called without an active
    exception") after its work was done."""
    devices, backend, timeout, threads = spec
    torch.set_num_threads(threads)
    code = 0
    try:
        fn, args = torch.load(os.path.join(tmp, "args.pt"),
                              weights_only=False)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), n),
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
        mesh = make_serving_mesh(n, devices=devices, backend=backend)
        out = fn(mesh, *args)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "result.pt"))
        del fn, args, mesh, out
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)

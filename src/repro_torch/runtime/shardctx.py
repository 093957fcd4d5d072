"""The tensor-parallel context of the serving step (port of the shard_map
half of `repro.runtime.shardctx`).

Tensor-parallel serving runs one process per rank (`launch.mesh`). Each
rank holds its slice of the attention heads and MLP hidden columns
(`launch.sharding`), so each layer's `wo` and `down` projections produce
partial sums over the rank's slice, and one all-reduce at each of those
boundaries (2L a step) restores the replicated residual stream. Model
code calls `psum_tp` there unconditionally (through
`models.layers.apply_linear(..., reduce_tp=True)`); it is the identity
when no group is bound, which is every path but a tensor-parallel
engine's steps (single-device serving, training, the tests of one
device).

`tp_group(group)` binds the process group while a step runs. On CUDA a
step that runs under it while a CUDA graph is captured calls its NCCL
all-reduces during the capture, which NCCL records into the graph for
every replay to run with no binding (at one rank NCCL launches nothing;
a capture across cards is not verified); an eager step (gloo, the CPU)
needs the binding at each call.

The reference's GSPMD half (`use_mesh`, `maybe_shard`, `logical_spec`,
`resolve_axis`) is not ported: the port has no compiler to partition a
whole-array program.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_TP_GROUP = None


@contextlib.contextmanager
def tp_group(group):
    """Bind `group` (a `torch.distributed` process group) as the
    tensor-parallel all-reduce group while the wrapped step runs or is
    captured."""
    global _TP_GROUP
    prev = _TP_GROUP
    _TP_GROUP = group
    try:
        yield
    finally:
        _TP_GROUP = prev


def get_tp_group():
    """The bound tensor-parallel group, or None."""
    return _TP_GROUP


def psum_tp(x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) a tensor-parallel partial over the bound group, in
    place; the identity when no group is bound."""
    if _TP_GROUP is None:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_TP_GROUP)
    return x

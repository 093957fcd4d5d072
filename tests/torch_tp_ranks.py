"""Rank functions for the tensor-parallel tests: each runs in every rank
process of a serving mesh (`repro_torch.launch.mesh.spawn`), so they live
in a module that imports neither jax nor the reference, and start
quickly. Each returns what rank 0 saw."""
import time

import torch
import torch.distributed

from repro_torch.api.engine import InferenceEngine
from repro_torch.launch import sharding as shd
from repro_torch.models.layers import apply_linear
from repro_torch.runtime import shardctx


def run_cases(mesh, cases):
    """cases: {name: dict(cfg, params, prompts, sampling, mode, and
    optional plan, build (InferenceEngine.build keywords))}: each case's
    engine built on this rank, then `mode` "serve" or "generate" run on
    its prompts. Returns {name: (outputs, counters)}."""
    out = {}
    for name, c in cases.items():
        eng = InferenceEngine.build(c["cfg"], c.get("plan"),
                                    params=c["params"], mesh=mesh,
                                    **c.get("build", {}))
        if c["mode"] == "serve":
            res = eng.serve(c["prompts"], c["sampling"])
            out[name] = ([o.copy() for o in res.outputs],
                         {"mixed_steps": res.mixed_steps,
                          "drafted": res.drafted,
                          "spec_rounds": res.spec_rounds})
        else:
            res = eng.generate(c["prompts"], c["sampling"])
            out[name] = (res.tokens.copy(), {})
    return out


def reduced_partials(mesh, xs, weights):
    """For each {kind: x (B, K)} and {kind: w}, a K-site weight at tree
    path "layers/mlp/down": this rank's slice of x and of w through
    apply_linear(..., reduce_tp=True) with the group bound, the
    all-reduced float32 sum."""
    tp, r = mesh.size, mesh.rank
    out = {}
    for kind, x in xs.items():
        k = x.shape[-1] // tp
        wr = shd.tp_shard_params({"layers": {"mlp": {"down": weights[kind]}}},
                                 tp, r)
        with torch.inference_mode(), shardctx.tp_group(mesh.group):
            out[kind] = apply_linear(x[:, r * k:(r + 1) * k],
                                     wr["layers"]["mlp"]["down"],
                                     out_dtype=torch.float32, reduce_tp=True)
    return out


def fail_on_rank_one(mesh):
    """Rank 1 raises; rank 0 waits for it in an all-reduce."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails here")
    torch.distributed.all_reduce(torch.zeros(1), group=mesh.group)


def hang(mesh):
    """Every rank sleeps past any test's time limit."""
    time.sleep(3600)

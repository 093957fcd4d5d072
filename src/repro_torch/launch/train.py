"""Training on one device (port of `repro.launch.train`): AdamW
with gradient accumulation, checkpoints, and restart on failure
(ResilientLoop).

  python -m repro_torch.launch.train --arch opus-mt --smoke --steps 20 \
      --batch 4 --seq 32 --ckpt-dir ckpt [--device cpu]

It runs on the GPU; `--device cpu` runs on the CPU. Checkpoints are in
the reference's format, so `--resume` continues a run of either package.
The modality-frontend archs (chameleon-34b, musicgen-medium) train on
embeddings: each batch's tokens become rows of a table drawn as the
reference draws it, normal(fold_in(PRNGKey(seed), 7), (V, d)) * 0.02
(`runtime.prng.normal`). Meshes are not ported (`--mesh` takes one device
only).
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile

import numpy as np
import torch

from repro_torch.api.engine import _full_fp32, resolve_device
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.launch.steps import apply_grads, loss_and_grads
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw
from repro_torch.runtime import prng
from repro_torch.runtime.fault import ResilientLoop


def make_accum_train_step(cfg, opt_cfg, microbatches: int):
    """A train step over `microbatches` equal slices of the batch: the
    slices' gradients summed in float32 and divided by their number, the
    loss their mean, the other metrics the last slice's."""
    def train_step(params, opt_state, batch):
        if microbatches <= 1:
            (loss, metrics), grads = loss_and_grads(params, batch, cfg)
        else:
            mb = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                               *x.shape[1:]) for k, x in batch.items()}
            gsum = [(p, torch.zeros_like(t, dtype=torch.float32))
                    for p, t in adamw.leaf_paths(params)]
            lsum = 0.0
            for i in range(microbatches):
                (l, metrics), g = loss_and_grads(
                    params, {k: x[i] for k, x in mb.items()}, cfg)
                gsum = [(p, s + t) for (p, s), (_, t)
                        in zip(gsum, adamw.leaf_paths(g))]
                lsum = lsum + l
            grads = adamw.unflatten((p, s / microbatches) for p, s in gsum)
            loss = lsum / microbatches
        params, new_opt, om = apply_grads(params, opt_state, grads, opt_cfg)
        return params, new_opt, {"loss": loss, **om}

    return train_step


def frontend_table(cfg, seed: int, device="cpu") -> torch.Tensor:
    """The frontend stub's embedding table, (V, d) in the model's dtype,
    drawn on `device`: the reference's normal(fold_in(PRNGKey(seed), 7),
    (V, d), dtype) * 0.02, the product rounded to the dtype as jax's
    weakly typed one."""
    dtype = dtype_of(cfg.dtype)
    key = prng.fold_in(prng.prng_key(seed).to(device), 7)
    table = prng.normal(key, (cfg.vocab_size, cfg.d_model), dtype)
    return table * torch.tensor(0.02, dtype=dtype, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opus-mt")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--opt-bits", type=int, default=32, choices=[32, 8])
    ap.add_argument("--data", default="markov", choices=["markov", "hash"])
    ap.add_argument("--mesh", default="auto",
                    help="auto | 1x1: one device")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh not in ("auto", "1x1"):
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; meshes "
            f"and data parallelism are ROADMAP A6")
    device = resolve_device(args.device)
    if device.type == "cuda":
        _full_fp32()
    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 5),
                                state_bits=args.opt_bits)

    params = tfm.init_params(cfg, seed=args.seed, device=device)
    opt_state = adamw.init(params, opt_cfg)
    if args.data == "markov":
        task = pipeline.MarkovTask(cfg.vocab_size, seed=args.seed)
        make = functools.partial(task.batch, batch=args.batch, seq=args.seq,
                                 device=device)
    else:
        make = functools.partial(pipeline.hash_batch, args.seed,
                                 batch=args.batch, seq=args.seq,
                                 vocab=cfg.vocab_size, device=device)
    if cfg.frontend in ("audio", "vision"):
        table, tokens = frontend_table(cfg, args.seed, device), make
        make = lambda s: pipeline.lift_to_embeddings(  # noqa: E731
            tokens(s), table)
    train_step = make_accum_train_step(cfg, opt_cfg, args.microbatches)

    state = {"params": params, "opt": opt_state}
    start = 0
    if args.resume and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        state, start = ckpt_lib.restore(args.ckpt_dir, state)
        print(f"[train] resumed from step {start}")

    def step_fn(state, step):
        p, o, metrics = train_step(state["params"], state["opt"], make(step))
        return {"params": p, "opt": o}, metrics

    def save_fn(state, step):
        ckpt_lib.save(args.ckpt_dir, step, state, async_save=False)

    def restore_fn():
        return ckpt_lib.restore(args.ckpt_dir, state)

    loop = ResilientLoop(step_fn, save_fn, restore_fn,
                         ckpt_every=args.ckpt_every,
                         inject_failure_at=args.inject_failure_at)
    # initial checkpoint so restore-on-failure always has a target
    save_fn(state, 0)
    state, end = loop.run(state, start, args.steps - start)
    save_fn(state, end)

    r = loop.report
    losses = r.losses
    print(f"[train] done: steps={r.steps_run} failures={r.failures} "
          f"restores={r.restores} stragglers={r.straggler_events}")
    if losses:
        k = max(len(losses) // 10, 1)
        print(f"[train] loss first10={np.mean(losses[:k]):.4f} "
              f"last10={np.mean(losses[-k:]):.4f}")
    return losses


if __name__ == "__main__":
    main()

"""Step functions (port of `repro.launch.steps`, less the dry run's
`build_cell` and abstract specs, which come with the dry run).

  train    -> train_step(params, opt_state, batch)  [loss + grads + AdamW]
  prefill  -> prefill_step(params, batch)           [forward + cache build]
  decode   -> serve_step(params, cache, tok, pos)   [1 token w/ KV cache]

The reference differentiates `loss_fn` with `jax.value_and_grad`; here
autograd does, over the float path of every layout (no kernel lies on
it): dense, moe, and the Mamba layouts (ssm, hybrid) through either scan
engine, "sequential" or "chunked" (`ssm_engine`, as the reference's; the
chunked engine recomputes each chunk's scan in the backward pass). The
train step writes the new parameters into the tensors it was given, as
the reference's jitted step donates them.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw


def loss_and_grads(params, batch, cfg, *, ssm_engine="sequential"):
    """((loss, metrics), grads) of `transformer.loss_fn` at `params`;
    grads has the tree of `params`, zeros for a leaf the loss does not
    read (the token embedding of a batch of `inputs_embeds`), as
    `jax.grad` gives. Nothing is recorded on `params` themselves (their
    gradients are taken through detached views). The Mamba blocks scan
    with `ssm_engine`."""
    leaves = adamw.leaf_paths(params)
    live = [(p, t.detach().requires_grad_(True)) for p, t in leaves]
    with torch.enable_grad():
        loss, metrics = tfm.loss_fn(adamw.unflatten(live), batch, cfg,
                                    ssm_engine=ssm_engine)
    # only a batch of `inputs_embeds` may leave a leaf out of the loss
    grads = torch.autograd.grad(loss, [t for _, t in live],
                                allow_unused="inputs_embeds" in batch)
    grads = [torch.zeros_like(t) if g is None else g
             for (_, t), g in zip(live, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return ((loss.detach(), metrics),
            adamw.unflatten((p, g) for (p, _), g in zip(live, grads)))


def apply_grads(params, opt_state, grads, opt_cfg: adamw.AdamWConfig):
    """AdamW on `grads`, the new parameters written into the tensors of
    `params`: (params, new opt state, {"grad_norm", "lr"})."""
    new_params, new_opt, om = adamw.update(grads, opt_state, params, opt_cfg)
    with torch.no_grad():
        for (_, p), (_, n) in zip(adamw.leaf_paths(params),
                                  adamw.leaf_paths(new_params)):
            p.copy_(n)
    return params, new_opt, om


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                    ssm_engine="sequential"):
    def train_step(params, opt_state, batch):
        (loss, metrics), grads = loss_and_grads(params, batch, cfg,
                                                ssm_engine=ssm_engine)
        params, new_opt, om = apply_grads(params, opt_state, grads, opt_cfg)
        return params, new_opt, {"loss": loss, "ce": metrics["ce"], **om}

    return train_step


def make_prefill_step(cfg, *, ssm_engine="sequential"):
    def prefill_step(params, batch):
        inputs = batch.get("inputs_embeds", batch.get("tokens"))
        return tfm.prefill(params, inputs, cfg, ssm_engine=ssm_engine)

    return prefill_step


def make_serve_step(cfg):
    def serve_step(params, cache, tok, pos):
        return tfm.decode_step(params, cache, tok, pos, cfg)

    return serve_step

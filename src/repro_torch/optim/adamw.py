"""AdamW with schedules, global-norm clipping and an 8-bit (blockwise int8)
state variant (port of `repro.optim.adamw`, less the ZeRO-1 sharding rule,
which comes with data parallelism).

Functional, as the reference: `update(grads, state, params, cfg)` returns
new parameters, a new state and the step's metrics; the trainer copies
the parameters back in place. Trees are nested dicts of tensors with the
reference's paths, and the state is the reference's
{"m", "v", "count"}, so state checkpoints move between the packages. With
`state_bits=8` every moment leaf is a node {"q": int8 (nblocks, 256),
"scale": fp32 (nblocks, 1)} (m: symmetric linear codes) or {"q", "scale",
"off"} (v: log-space codes), re-quantized after every update.

Arithmetic follows the reference's order, in float32. Its `update` is
jitted, and XLA turns a division by a constant into the product with the
float32 reciprocal, so `absmax / 127` and `(hi - lo) / 254` are such
products here; the other divisions are true divisions.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # cosine | linear | constant
    state_bits: int = 32            # 32 | 8


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int tensor): a linear warmup over
    `warmup_steps`, then cosine or linear decay to 0 at `total_steps`,
    or constant; float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


# --------------------------------------------------- blockwise int8 state --
_BLK = 256
_VLOG_FLOOR = 1e-16
_INV127 = float(np.float32(1.0) / np.float32(127.0))
_INV254 = float(np.float32(1.0) / np.float32(254.0))


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    return F.pad(flat, (0, (-flat.numel()) % _BLK)).reshape(-1, _BLK)


def _q8(x: torch.Tensor) -> dict:
    """Symmetric linear int8 (for the signed first moment m)."""
    blocks = _blocks(x.reshape(-1))
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * _INV127, 1.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _dq8(s: dict, shape) -> torch.Tensor:
    flat = (s["q"].to(torch.float32) * s["scale"]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def _q8log(x: torch.Tensor) -> dict:
    """Log-space int8 (for the non-negative second moment v): bounds the
    relative error, where linear codes would crush small v in a block
    that also holds large ones."""
    flat = torch.clamp(x.reshape(-1), min=0.0)
    blocks = torch.log(_blocks(flat) + _VLOG_FLOOR)
    lo = blocks.amin(dim=1, keepdim=True)
    hi = blocks.amax(dim=1, keepdim=True)
    scale = torch.clamp(hi - lo, min=1e-6) * _INV254
    q = torch.clamp(torch.round((blocks - lo) / scale) - 127, -127,
                    127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32),
            "off": lo.to(torch.float32)}


def _dq8log(s: dict, shape) -> torch.Tensor:
    blocks = torch.exp((s["q"].to(torch.float32) + 127.0) * s["scale"]
                       + s["off"]) - _VLOG_FLOOR
    flat = torch.clamp(blocks, min=0.0).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


# ------------------------------------------------------------------ trees --
def leaf_paths(tree, prefix=()) -> list:
    """[(path tuple, leaf)] of a dict tree, keys sorted at every level (the
    reference's leaf order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaf_paths(v, (*prefix, k)))
        else:
            out.append(((*prefix, k), v))
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def unflatten(items) -> dict:
    """The dict tree of [(path tuple, leaf)]."""
    out: dict = {}
    for path, v in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


# ----------------------------------------------------------------- adamw --
def init(params, cfg: AdamWConfig) -> dict:
    """Zero moments for every leaf of `params` (on its device) and count 0."""
    def zeros(p, log=False):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.state_bits == 8:
            return _q8log(z) if log else _q8(z)
        return z

    leaves = leaf_paths(params)
    device = leaves[0][1].device
    return {"m": unflatten((p, zeros(x)) for p, x in leaves),
            "v": unflatten((p, zeros(x, log=True)) for p, x in leaves),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, float32, summed
    leaf by leaf in the reference's order."""
    total = 0
    for _, leaf in leaf_paths(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


def update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step. Returns (new_params, new_state, {"grad_norm",
    "lr"}): gradients clipped to `clip_norm` by their global norm,
    bias-corrected moments, decoupled weight decay on leaves of two or
    more dimensions only."""
    count = state["count"] + 1
    lr = schedule_lr(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, c)
    bc2 = 1 - torch.pow(cfg.b2, c)

    new_p, new_m, new_v = [], [], []
    for path, g in leaf_paths(grads):
        m, v, p = _at(state["m"], path), _at(state["v"], path), \
            _at(params, path)
        g = g.to(torch.float32) * scale
        if cfg.state_bits == 8:
            m = _dq8(m, g.shape)
            v = _dq8log(v, g.shape)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        newp = p.to(torch.float32) * (1 - lr * decay) - lr * upd
        if cfg.state_bits == 8:
            m, v = _q8(m), _q8log(v)
        new_p.append((path, newp.to(p.dtype)))
        new_m.append((path, m))
        new_v.append((path, v))
    new_state = {"m": unflatten(new_m), "v": unflatten(new_v),
                 "count": count}
    return unflatten(new_p), new_state, {"grad_norm": gnorm, "lr": lr}

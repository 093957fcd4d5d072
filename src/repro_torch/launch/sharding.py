"""Tensor-parallel slicing of the serving weights (port of the shard_map
half of `repro.launch.sharding`).

Each rank holds a literal slice of every sharded leaf; nothing pads, so
the heads and the MLP hidden dim must divide the rank count exactly
(`check_tp_geometry` raises otherwise). The slice axis keeps each rank's
work a column or row block of the whole product:

  * N-sites (wq, wk, wv, gate, up: replicated input, output columns
    sliced) are bit-exact per rank. A low-rank cascade there keeps its
    whole w1 and slices only w2's output columns, so its intermediate
    activation quantization sees the same tensor on every rank.
  * K-sites (wo, down: input features sliced, full output) give partial
    sums that the layer boundary all-reduces (`runtime.shardctx`). A
    cascade there slices w1's input rows and keeps its per-column scale
    and w2 whole; a compressed K-site requantizes its activations over
    the rank's own features, which is close to the single-device engine
    but not bit-equal to it (the reference's behaviour).

Packed W4 leaves hold two adjacent columns in a byte along their last
axis (`core.quant.pack_int4`), so a column slice of the packed bytes is a
contiguous range of logical columns whenever the packed width divides.

Actions are "col" (slice the last dim), "row" (the second to last) and
"rep" (replicate); the rules and their order are the reference's
`_TP_RULES`, over the same "/"-joined paths ("layers/attn/wq/w1/values").
The reference's GSPMD rules (`spec_for`, `param_shardings`, the cache and
optimizer shardings) are not ported: the port has no compiler to
partition whole-array programs.
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.core.compress import flatten, map_with_path
from repro_torch.core.itera import LowRankQ
from repro_torch.core.quant import QuantizedTensor

_TP_N = r"/(wq|wk|wv|gate|up)"
_TP_K = r"/(wo|down)"

# (regex, action): first match wins
_TP_RULES = [
    (_TP_N + r"/w1/(values|scale)$", "rep"),
    (_TP_N + r"/w2/values$", "col"),
    (_TP_N + r"/w2/scale$", "rep"),       # (R, 1) per-rank-row scale
    (_TP_K + r"/w1/values$", "row"),
    (_TP_K + r"/w1/scale$", "rep"),       # (1, R) per-column scale
    (_TP_K + r"/w2/(values|scale)$", "rep"),
    (_TP_N + r"(/values|/scale)?$", "col"),
    (_TP_K + r"/values$", "row"),
    (_TP_K + r"/scale$", "rep"),          # (1, N) per-output-column scale
    (_TP_K + r"$", "row"),
]


def check_tp_geometry(cfg, tp: int) -> None:
    """Raise unless `cfg` shards cleanly over `tp` ranks; the error names
    the ModelConfig field to fix."""
    if tp <= 1:
        return
    if cfg.layout != "dense":
        raise NotImplementedError(
            f"tensor-parallel serving supports layout='dense' only, got "
            f"layout={cfg.layout!r}")
    bad = [f"ModelConfig.{name}={val}" for name, val in
           (("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads),
            ("d_ff", cfg.d_ff)) if val % tp]
    if bad:
        raise ValueError(
            f"model geometry does not divide the tensor-parallel axis "
            f"(tp={tp}): {', '.join(bad)}. Each rank holds a literal slice "
            f"-- there is no GSPMD padding -- so attention/KV heads and "
            f"the MLP hidden dim must each be a multiple of the mesh "
            f"'model' axis size.")


def tp_local_config(cfg, tp: int):
    """The per-rank ModelConfig: num_heads / tp query heads and
    num_kv_heads / tp KV heads (head_dim is a concrete field, so it
    survives; d_model and d_ff stay, the weight slices carry the hidden
    split)."""
    if tp <= 1:
        return cfg
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def tp_spec_for(path: str, leaf, tp: int) -> tuple:
    """(action, dim) for one tensor leaf under `tp`-way TP: ("col", its
    last dim), ("row", the one before) or ("rep", None)."""
    ndim = leaf.ndim
    if tp <= 1 or ndim < 2:
        return "rep", None
    action = next((act for pat, act in _TP_RULES if re.search(pat, path)),
                  "rep")
    if action == "rep":
        return "rep", None
    dim = ndim - 1 if action == "col" else ndim - 2
    if leaf.shape[dim] % tp:
        raise ValueError(
            f"TP cannot slice {path}: dim {dim} has size {leaf.shape[dim]}"
            f", not divisible by tp={tp} (packed sub-8-bit leaves halve "
            f"the packed axis -- geometry must divide after packing)")
    return action, dim


def _tensors(path: str, leaf) -> dict:
    """{path: tensor} of one leaf of the tree, a compressed node's arrays
    under the reference's field names."""
    if isinstance(leaf, LowRankQ):
        return {**_tensors(f"{path}/w1", leaf.w1),
                **_tensors(f"{path}/w2", leaf.w2)}
    if isinstance(leaf, QuantizedTensor):
        return {f"{path}/values": leaf.values, f"{path}/scale": leaf.scale}
    return {path: leaf}


def tp_param_specs(params, tp: int) -> dict:
    """{path: (action, dim)} for every tensor of the serving params."""
    out = {}
    for path, leaf in flatten(params).items():
        for p, t in _tensors(path, leaf).items():
            out[p] = tp_spec_for(p, t, tp)
    return out


def _slice(path: str, t, tp: int, rank: int):
    action, dim = tp_spec_for(path, t, tp)
    if action == "rep":
        return t
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).contiguous()


def tp_shard_params(params, tp: int, rank: int):
    """The literal slice of `params` that rank `rank` of `tp` holds:
    sliced leaves are fresh contiguous tensors, replicated ones the
    tree's own."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} out of range for tp={tp}")

    def node(path, q: QuantizedTensor) -> QuantizedTensor:
        return dataclasses.replace(
            q, values=_slice(f"{path}/values", q.values, tp, rank),
            scale=_slice(f"{path}/scale", q.scale, tp, rank))

    def one(path, leaf):
        if isinstance(leaf, LowRankQ):
            return LowRankQ(node(f"{path}/w1", leaf.w1),
                            node(f"{path}/w2", leaf.w2))
        if isinstance(leaf, QuantizedTensor):
            return node(path, leaf)
        return _slice(path, leaf, tp, rank)

    return map_with_path(one, params)

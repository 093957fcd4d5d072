"""Weights of the JAX reference package, as the port's parameter tree.

Reads the framework-neutral form the reference writes with
`repro.checkpoint.ckpt.save`, with numpy alone (no jax):

  * `from_flat(arrays, quant_formats)`: a flat {key: np.ndarray} dict
    keyed as that checkpoint's `arrays.npz` -- one part per tree level,
    joined by "|", each part a tag and a name: "k:" for a dict key, "x:"
    or "a:" for a field of a compressed node, e.g.
    "k:layers|k:attn|k:wq|x:w1|x:values" -- and the manifest's
    `quant_formats` {node key: {wl, axis, packed, act_wl}}, one entry per
    QuantizedTensor node;
  * `load_checkpoint(path)`: a checkpoint directory (`arrays.npz` and
    `manifest.json`), or a directory of `step_XXXXXXXX` checkpoints, of
    which the latest is read.

The result is the port's tree: nested dicts of tensors, with every
QuantizedTensor rebuilt with its `wl/axis/packed/act_wl` and every node
whose fields are exactly two such tensors `w1`, `w2` as a LowRankQ. Codes
and scales are the reference's bytes, packed nibbles included. The key
scheme is `checkpoint.ckpt`'s, which also writes it. bfloat16 arrays
(2-byte void in the npz, "bfloat16" in the manifest's `dtypes`) become
bfloat16 tensors byte for byte.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.checkpoint.ckpt import (SEP, key_names, latest_step,
                                         tensor_of)
from repro_torch.core.itera import LowRankQ
from repro_torch.core.quant import QuantizedTensor


def _put(tree: dict, key: str, value) -> None:
    *parents, leaf = key_names(key)
    node = tree
    for p in parents:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise ValueError(f"{key}: a leaf already sits at {p!r}")
    if leaf in node:
        raise ValueError(f"{key}: duplicate tree path")
    node[leaf] = value


def _lowrank(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lowrank(v) for k, v in node.items()}
    if set(out) == {"w1", "w2"} and all(
            isinstance(v, QuantizedTensor) for v in out.values()):
        return LowRankQ(out["w1"], out["w2"])
    return out


def from_flat(arrays: dict, quant_formats: dict | None = None, *,
              device="cpu", dtypes: dict | None = None) -> dict:
    """The port's parameter tree from checkpoint-keyed arrays (see the
    module docstring), on `device`; `dtypes` is the manifest's {key: dtype
    name}, which a bfloat16 array needs."""
    dtypes = dtypes or {}
    used = set()
    tree: dict = {}
    for qkey, fmt in (quant_formats or {}).items():
        fields = {}
        for key in arrays:
            if key.startswith(qkey + SEP):
                rest = key[len(qkey) + 1:]
                if SEP not in rest:
                    fields[key_names(rest)[0]] = key
        if set(fields) != {"values", "scale"}:
            raise ValueError(f"{qkey}: a quantized node needs arrays "
                             f"'values' and 'scale', found {sorted(fields)}")
        used.update(fields.values())
        q = QuantizedTensor(tensor_of(arrays[fields["values"]],
                                      dtypes.get(fields["values"])).to(device),
                            tensor_of(arrays[fields["scale"]],
                                      dtypes.get(fields["scale"])).to(device),
                            wl=int(fmt["wl"]), axis=int(fmt["axis"]),
                            packed=bool(fmt.get("packed", False)),
                            act_wl=int(fmt.get("act_wl", 8)))
        _put(tree, qkey, q)
    for key, arr in arrays.items():
        if key not in used:
            _put(tree, key, tensor_of(arr, dtypes.get(key)).to(device))
    return _lowrank(tree)


def load_checkpoint(path: str, *, device="cpu") -> dict:
    """The port's parameter tree from a checkpoint written by the
    reference's `ckpt.save` (a step directory, or the directory holding
    the steps, of which the latest is read)."""
    if not os.path.exists(os.path.join(path, "manifest.json")):
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    missing = sorted(set(manifest["keys"]) - set(arrays))
    if missing:
        raise KeyError(f"arrays.npz lacks manifest keys {missing[:5]}")
    return from_flat(arrays, manifest.get("quant_formats", {}), device=device,
                     dtypes=manifest.get("dtypes", {}))

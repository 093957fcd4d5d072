"""Checkpoints in the reference's on-disk format (port of
`repro.checkpoint.ckpt`): atomic manifest-committed saves, an optional
save thread, keep-last-k garbage collection, and restore into a `like`
tree on a device.

Layout, the same files as the reference writes and reads:

  <dir>/step_000123.tmp/       (written)
  <dir>/step_000123/           (atomic rename = commit)
    manifest.json              step, keys, shapes, dtypes, quant_formats
    arrays.npz                 the flattened tree, path-keyed

A tree is nested dicts of tensors, QuantizedTensor and LowRankQ nodes
(a parameter tree, a compressed one, or a train state {"params", "opt":
{"m", "v", "count"}}). Its keys join one part per level with "|": "k:"
and a dict key, "x:" and a field of a compressed node ("values", "scale";
"w1", "w2"), e.g. "k:layers|k:attn|k:wq|x:w1|x:values". `quant_formats`
records each QuantizedTensor's {wl, axis, packed, act_wl}. `bridge`
reads the same keys into a tree without a `like`.

bfloat16 arrays are stored as the reference stores them: numpy has no
bfloat16, so `arrays.npz` holds their bytes as 2-byte void (`|V2`) and the
manifest's `dtypes` says "bfloat16". `host_array` and `tensor_of` move
them byte for byte, never through float32.

Restore never trusts a directory without a manifest (a crash mid-save
leaves only *.tmp, which the next save removes).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.itera import LowRankQ
from repro_torch.core.quant import QuantizedTensor

SEP = "|"
_TAGS = ("k", "x", "a")


def key_names(key: str) -> list:
    """The tree path of a checkpoint key: its parts' names."""
    out = []
    for part in key.split(SEP):
        tag, sep, name = part.partition(":")
        if not sep or tag not in _TAGS:
            raise ValueError(f"unsupported checkpoint key part {part!r} "
                             f"(expected one of {[t + ':' for t in _TAGS]})")
        out.append(name)
    return out


def _children(node):
    """(part, child) of a tree node, or None for a leaf tensor."""
    if isinstance(node, dict):
        return [(f"k:{k}", v) for k, v in node.items()]
    if isinstance(node, LowRankQ):
        return [("x:w1", node.w1), ("x:w2", node.w2)]
    if isinstance(node, QuantizedTensor):
        return [("x:values", node.values), ("x:scale", node.scale)]
    return None


def flatten(tree, prefix: str = "") -> dict:
    """{checkpoint key: leaf tensor} of a tree."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for part, child in kids:
        out.update(flatten(child, f"{prefix}{SEP}{part}" if prefix else part))
    return out


def quant_formats(tree, prefix: str = "") -> dict:
    """{key: {wl, axis, packed, act_wl}} for every QuantizedTensor node:
    the layout the codes were stored in, so that restore can refuse a
    tree built for another one."""
    if isinstance(tree, QuantizedTensor):
        return {prefix: {"wl": int(tree.wl), "axis": int(tree.axis),
                         "packed": bool(tree.packed),
                         "act_wl": int(tree.act_wl)}}
    out = {}
    for part, child in _children(tree) or []:
        out.update(quant_formats(child, f"{prefix}{SEP}{part}"
                                 if prefix else part))
    return out


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy, taken now: later in-place updates do not reach it; a
    bfloat16 tensor as its bytes in 2-byte void (`|V2`), as the
    reference's numpy writes bfloat16."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def dtype_name(t: torch.Tensor) -> str:
    """The manifest's name of a tensor's dtype: numpy's, or "bfloat16"."""
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(np.dtype(str(t.dtype).removeprefix("torch.")))


def tensor_of(arr, name: str | None = None) -> torch.Tensor:
    """A CPU tensor of a checkpoint array: `name` "bfloat16" (the
    manifest's dtype) reads 2-byte void as bfloat16 bytes; other void or
    object arrays are refused."""
    a = np.asarray(arr)
    if name == "bfloat16":
        if a.dtype.itemsize != 2:
            raise TypeError(f"a bfloat16 array needs 2-byte items, got "
                            f"{a.dtype}")
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    if a.dtype.kind not in "biuf":
        raise TypeError(f"unsupported array dtype {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True))


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         async_save: bool = False):
    """Write a checkpoint of `tree` at `step`, keeping the newest `keep`.
    The tensors are copied to the host before this returns; with
    async_save the files are written on a thread, which is returned
    (join it)."""
    flat = flatten(tree)
    arrays = {k: host_array(v) for k, v in flat.items()}
    dtypes = {k: dtype_name(v) for k, v in flat.items()}
    fmts = quant_formats(tree)

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        name = f"step_{step:08d}"
        tmp = os.path.join(ckpt_dir, name + ".tmp")
        final = os.path.join(ckpt_dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": dtypes,
            "quant_formats": fmts,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic commit
        _gc(ckpt_dir, keep)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    for d in os.listdir(ckpt_dir):                 # crashed partial saves
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def list_steps(ckpt_dir: str) -> list:
    """The committed steps (a directory with a manifest), ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str):
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _rebuild(like, leaves: dict, prefix: str = ""):
    """`like` with each leaf tensor replaced by leaves[its key]."""
    kids = _children(like)
    if kids is None:
        return leaves[prefix]
    new = {part: _rebuild(child, leaves,
                          f"{prefix}{SEP}{part}" if prefix else part)
           for part, child in kids}
    if isinstance(like, dict):
        return {k: new[f"k:{k}"] for k in like}
    if isinstance(like, LowRankQ):
        return LowRankQ(new["x:w1"], new["x:w2"])
    return dataclasses.replace(like, values=new["x:values"],
                               scale=new["x:scale"])


def restore(ckpt_dir: str, like, step: int | None = None):
    """(tree, step): the checkpoint at `step` (default the latest) in the
    structure, dtypes and compressed layouts of `like`, each tensor on
    the device of the `like` leaf it replaces. Raises
    KeyError when the checkpoint lacks a key of `like`, ValueError on a
    shape or a quantized layout (wl, axis, packed) that differs from
    `like`'s; act_wl is run-time only and `like`'s wins."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = flatten(like)
    missing = [k for k in flat if k not in manifest["keys"]]
    if missing:
        raise KeyError(f"checkpoint at step {step} missing keys: "
                       f"{missing[:5]}{'...' if len(missing) > 5 else ''}")

    saved_fmts = manifest.get("quant_formats")
    if saved_fmts is not None:
        want_fmts = quant_formats(like)
        layout = ("wl", "axis", "packed")
        for key in sorted(set(saved_fmts) & set(want_fmts)):
            got = {f: saved_fmts[key].get(f) for f in layout}
            want = {f: want_fmts[key].get(f) for f in layout}
            if got != want:
                raise ValueError(
                    f"{key}: checkpoint quant layout {got} != expected "
                    f"{want} — rebuild `like` with the plan this "
                    f"checkpoint was compressed under")

    leaves = {}
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in flat.items():
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"expected {tuple(leaf.shape)}")
            leaves[key] = tensor_of(arr, dtypes.get(key)).to(
                device=leaf.device, dtype=leaf.dtype)
    return _rebuild(like, leaves), step

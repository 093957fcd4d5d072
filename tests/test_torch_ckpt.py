"""The port's checkpoints against the reference's, both ways, on the CPU:
the port saves and the reference restores, the reference saves (a
compressed tree, and a train state with 8-bit AdamW moments) and the port
restores; both write the same manifest. Then the guards (a missing key, a
shape, a quantized layout), keep-last-k, the removal of crashed partial
saves and the save thread."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as jplan
from repro.checkpoint import ckpt as jck
from repro.configs import get_config as j_get_config
from repro.core import compress as jcomp
from repro.models import transformer as jtfm
from repro.optim import adamw as jadam
from repro_torch import bridge
from repro_torch.api.plan import CompressionPlan, merge_plans
from repro_torch.checkpoint import ckpt as tck
from repro_torch.core import compress as tcomp
from repro_torch.core.quant import QuantizedTensor
from repro_torch.optim import adamw as tadam

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref_params():
    return jtfm.init_params(jax.random.PRNGKey(0),
                            j_get_config("opus-mt", smoke=True))


def _to_port(tree):
    return bridge.from_flat(jck._flatten(tree))


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _ref_state(jp, bits):
    """The reference's train state after one AdamW update."""
    cfg = jadam.AdamWConfig(lr=1e-2, warmup_steps=1, state_bits=bits)
    g = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype)
                               * jnp.arange(p.size).reshape(p.shape) % 3, jp)
    p, opt, _ = jadam.update(g, jadam.init(jp, cfg), jp, cfg)
    return {"params": p, "opt": opt}


def _equal_trees(ref_tree, port_tree):
    want, got = jck._flatten(ref_tree), tck.flatten(port_tree)
    assert sorted(want) == sorted(got)
    for key, a in want.items():
        b = got[key].detach().cpu().numpy()
        assert b.dtype == a.dtype and np.array_equal(a, b), key


@pytest.mark.parametrize("bits", [32, 8])
def test_port_saves_and_reference_restores_a_train_state(ref_params, bits,
                                                         tmp_path):
    """A train state {"params", "opt": {"m", "v", "count"}} saved by the
    port is restored by the reference into its own structure, array for
    array; the reference's save of it writes the port's manifest."""
    state = _ref_state(ref_params, bits)
    tck.save(str(tmp_path / "port"), 7, _to_port(state))
    like = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
    got, step = jck.restore(str(tmp_path / "port"), like)
    assert step == 7
    _equal_trees(got, _to_port(state))
    jck.save(str(tmp_path / "ref"), 7, got)
    assert (_manifest(tmp_path / "port", 7)
            == _manifest(tmp_path / "ref", 7))


def test_reference_saves_a_compressed_tree_the_port_restores(ref_params,
                                                             tmp_path):
    """A tree compressed by the reference (ITERA W4 in attention,
    quant-only packed W4 in the MLP and lm head) restores into the port's own
    compressed tree of the same plan: the reference's bytes, packed
    nibbles included; `bridge.load_checkpoint` reads the same; the port's
    save of it writes the reference's manifest."""
    mixed = {"itera": r"attn", "quant": r"mlp|lm_head"}
    jcp, _ = jcomp.compress_params(ref_params, jplan.merge_plans(*[
        jplan.CompressionPlan.uniform(ref_params, method=m, weight_wl=wl,
                                      rank_fraction=0.5, include=inc)
        for m, wl, inc in (("itera", 4, mixed["itera"]),
                           ("quant", 4, mixed["quant"]))]))
    jck.save(str(tmp_path / "ref"), 3, jcp)
    tp = _to_port(ref_params)
    like, _ = tcomp.compress_params(tp, merge_plans(*[
        CompressionPlan.uniform(tp, method=m, weight_wl=wl,
                                rank_fraction=0.5, include=inc)
        for m, wl, inc in (("itera", 4, mixed["itera"]),
                           ("quant", 4, mixed["quant"]))]))
    got, step = tck.restore(str(tmp_path / "ref"), like)
    assert step == 3
    _equal_trees(jcp, got)
    _equal_trees(jcp, bridge.load_checkpoint(str(tmp_path / "ref")))
    assert got["lm_head"].packed and got["layers"]["attn"]["wq"].w1.wl == 4
    tck.save(str(tmp_path / "port"), 3, got)
    assert _manifest(tmp_path / "port", 3) == _manifest(tmp_path / "ref", 3)


def test_reference_saves_8bit_state_the_port_restores(ref_params, tmp_path):
    """The reference's 8-bit AdamW state ({"q", "scale"[, "off"]} moment
    nodes) restores into the port's `adamw.init` tree, dtype and all."""
    state = _ref_state(ref_params, 8)
    jck.save(str(tmp_path), 1, state)
    tp = _to_port(ref_params)
    like = {"params": tp,
            "opt": tadam.init(tp, tadam.AdamWConfig(state_bits=8))}
    got, _ = tck.restore(str(tmp_path), like)
    _equal_trees(state, got)
    assert got["opt"]["v"]["embed"]["q"].dtype == torch.int8
    assert got["opt"]["count"].dtype == torch.int32


def test_restore_refuses_a_missing_key_and_a_shape(ref_params, tmp_path):
    tp = _to_port(ref_params)
    tck.save(str(tmp_path), 0, tp)
    with pytest.raises(KeyError, match="missing keys"):
        tck.restore(str(tmp_path), {**tp, "extra": torch.zeros(2)})
    bad = {**tp, "lm_head": torch.zeros(3, 5)}
    with pytest.raises(ValueError, match="k:lm_head: checkpoint shape"):
        tck.restore(str(tmp_path), bad)
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "none"), tp)


def test_restore_guards_the_quantized_layout(ref_params, tmp_path):
    """A packed W4 checkpoint does not restore into a carrier-layout tree
    (ValueError naming the node); a different act_wl restores, and the
    `like` tree's wins."""
    tp = _to_port(ref_params)
    cfg = tcomp.CompressionConfig(method="quant", weight_wl=4)
    packed, _ = tcomp.compress_params(tp, cfg)
    tck.save(str(tmp_path), 0, packed)
    carrier, _ = tcomp.compress_params(
        tp, tcomp.CompressionConfig(method="quant", weight_wl=4, pack=False))
    with pytest.raises(ValueError, match="quant layout"):
        tck.restore(str(tmp_path), carrier)
    a6 = tcomp.map_with_path(
        lambda _, x: (QuantizedTensor(x.values, x.scale, x.wl, x.axis,
                                      x.packed, act_wl=6)
                      if isinstance(x, QuantizedTensor) else x), packed)
    got, _ = tck.restore(str(tmp_path), a6)
    assert got["lm_head"].act_wl == 6
    assert torch.equal(got["lm_head"].values, packed["lm_head"].values)


def test_keep_last_k_and_partial_saves(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    os.makedirs(tmp_path / "step_00000009.tmp")      # a crashed save
    for step in range(1, 6):
        tck.save(str(tmp_path), step, tree, keep=2)
    assert tck.list_steps(str(tmp_path)) == [4, 5]
    assert tck.latest_step(str(tmp_path)) == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    os.makedirs(tmp_path / "step_00000006")          # no manifest
    assert tck.latest_step(str(tmp_path)) == 5


def test_save_thread_writes_the_tensors_as_they_were(tmp_path):
    """With async_save the host copy is taken before save returns: an
    in-place update afterwards does not reach the checkpoint."""
    w = torch.arange(1000, dtype=torch.float32)
    t = tck.save(str(tmp_path), 2, {"w": w}, async_save=True)
    w.add_(1.0)
    t.join(timeout=30)
    assert not t.is_alive()
    got, step = tck.restore(str(tmp_path), {"w": torch.empty(1000)})
    assert step == 2
    assert torch.equal(got["w"], torch.arange(1000, dtype=torch.float32))


def test_bridge_reads_what_the_port_saves(ref_params, tmp_path):
    tp = _to_port(ref_params)
    tck.save(str(tmp_path), 4, tp)
    got = bridge.load_checkpoint(str(tmp_path))
    a, b = tck.flatten(tp), tck.flatten(got)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)

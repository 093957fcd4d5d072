"""The whole slice: a model compressed by the JAX reference, saved with its
checkpoint module, read by `repro_torch.bridge`, and served by the port's
engine on the CPU, against the reference engine on the same weights."""
import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import engine as jengine
from repro.api import plan as jplan
from repro.checkpoint import ckpt
from repro.configs import get_config as j_get_config
from repro.models import transformer as jtfm
from repro.runtime import kvblocks as jkv
from repro_torch import bridge
from repro_torch.api import engine as tengine
from repro_torch.api import plan as tplan
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.compress import flatten
from repro_torch.core.itera import LowRankQ
from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttfm
from repro_torch.runtime import kvblocks as tkv

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """Smoke-size opus-mt compressed by the reference (ITERA W4, packed
    where the packing rule allows), and the same weights in the port."""
    cfg = j_get_config("opus-mt", smoke=True)
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    plan = jplan.CompressionPlan.uniform(params, method="itera",
                                         weight_wl=4, rank_fraction=0.5)
    jeng = jengine.InferenceEngine.build(cfg, plan, params=params)
    path = tmp_path_factory.mktemp("ckpt")
    ckpt.save(str(path), 0, jeng.params)
    return cfg, jeng.params, bridge.load_checkpoint(str(path)), path


def test_bridge_keeps_every_byte_and_layout(bridged):
    _, jparams, tparams, path = bridged
    step = path / "step_00000000"
    manifest = json.loads((step / "manifest.json").read_text())
    arrays = np.load(step / "arrays.npz")
    leaves = flatten(tparams)
    n_lowrank = 0
    for key in manifest["keys"]:
        names = [p.split(":", 1)[1] for p in key.split("|")]
        node, field = tparams, None
        for i, name in enumerate(names):
            if isinstance(node, dict):
                node = node[name]
            else:                             # inside a compressed node
                field = field or names[i:]
                node = getattr(node, name)
        got = node.numpy()
        np.testing.assert_array_equal(got, arrays[key], key)
        assert got.dtype == arrays[key].dtype, key
        if field:
            n_lowrank += field[0] in ("w1", "w2")
    assert n_lowrank > 0
    fmts = manifest["quant_formats"]
    packed = 0
    for path_, leaf in leaves.items():
        assert isinstance(leaf, (torch.Tensor, LowRankQ))
        if isinstance(leaf, LowRankQ):
            key = "|".join(f"k:{p}" for p in path_.split("/"))
            for f in ("w1", "w2"):
                q = getattr(leaf, f)
                assert isinstance(q, QuantizedTensor)
                assert fmts[f"{key}|x:{f}"] == {
                    "wl": q.wl, "axis": q.axis, "packed": q.packed,
                    "act_wl": q.act_wl}
                packed += q.packed
    assert packed > 0


def _step_inputs(cfg, bs=4):
    """A ragged first step (two prefill chunks and an idle row) and the
    decode step after it."""
    rng = np.random.default_rng(0)
    ql = np.array([7, 3, 0], np.int32)
    toks = rng.integers(1, cfg.vocab_size, (3, 8)).astype(np.int32)
    mb = 3
    table = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    return toks, ql, table, 1 + 2 * mb, mb


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_unified_step_logits_match_reference(bridged, kv_bits):
    cfg, jparams, tparams, _ = bridged
    cfg_j = dataclasses.replace(cfg, kv_cache_bits=kv_bits)
    cfg_t = dataclasses.replace(t_get_config("opus-mt", smoke=True),
                                kv_cache_bits=kv_bits)
    toks, ql, table, nb, _ = _step_inputs(cfg)
    jpool = jkv.init_paged_cache(cfg_j, nb, 4)
    tpool = tkv.init_paged_cache(cfg_t, nb, 4, "cpu")
    ctx = np.zeros(3, np.int32)
    for step in range(2):
        lj, jpool = jtfm.unified_step(jparams, jpool, jnp.asarray(table),
                                      jnp.asarray(ctx), jnp.asarray(ql),
                                      jnp.asarray(toks), cfg_j)
        lt, tpool = ttfm.unified_step(tparams, tpool, torch.from_numpy(table),
                                      torch.from_numpy(ctx),
                                      torch.from_numpy(ql),
                                      torch.from_numpy(toks), cfg_t)
        assert tuple(lt.shape) == (3, 1, cfg.vocab_size)
        live = ql > 0
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live],
                                   rtol=0, atol=1e-4, err_msg=f"step {step}")
        # then one decode token per live row, at its next position (the
        # span width stays 8, so the reference compiles one step)
        ctx = ctx + ql
        toks = np.zeros_like(toks)
        toks[:, 0] = np.argmax(np.asarray(lj)[:, -1], -1)
        ql = live.astype(np.int32)


def _shared_workload(vocab, seed=0):
    """9 requests: 6 share a 12-token prefix (3 full blocks at bs=4) with
    distinct tails, 1 duplicates the first, 1 is unrelated, and the last
    is the bare prefix (a fully cached prompt: the copy-on-write path)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=12).astype(np.int32)
    reqs = [np.concatenate([prefix, rng.integers(1, vocab, size=2 + i % 4)
                            .astype(np.int32)]) for i in range(6)]
    reqs.append(np.concatenate([prefix, reqs[0][12:]]))
    reqs.append(rng.integers(1, vocab, size=9).astype(np.int32))
    reqs.append(prefix.copy())
    return reqs


@pytest.fixture(scope="module")
def reference_serves(bridged):
    """The reference engine's greedy outputs per (kv_bits, prefix_cache)."""
    cfg, jparams, _, _ = bridged
    out = {}
    for kv_bits in (16, 8):
        eng = jengine.InferenceEngine(
            dataclasses.replace(cfg, kv_cache_bits=kv_bits), jparams,
            max_batch=3, block_size=4, chunk_tokens=8)
        for cache in (False, True):
            out[kv_bits, cache] = eng.serve(
                _shared_workload(cfg.vocab_size),
                jengine.SamplingParams(max_tokens=5), prefix_cache=cache)
    return out


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_serve_is_token_identical_to_reference(bridged, reference_serves,
                                               kv_bits, prefix_cache):
    cfg, _, tparams, _ = bridged
    eng = tengine.InferenceEngine.build(
        t_get_config("opus-mt", smoke=True), None, params=tparams,
        device="cpu", kv_bits=kv_bits, max_batch=3, block_size=4,
        chunk_tokens=8)
    got = eng.serve(_shared_workload(cfg.vocab_size),
                    tengine.SamplingParams(max_tokens=5),
                    prefix_cache=prefix_cache)
    want = reference_serves[kv_bits, prefix_cache]
    for i, (a, b) in enumerate(zip(got.outputs, want.outputs)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    for f in ("steps", "prefill_chunks", "prefill_tokens", "mixed_steps",
              "max_queue_depth", "cache_lookup_blocks", "cache_hit_blocks",
              "cache_hit_tokens", "cache_cow_blocks", "preemptions"):
        assert getattr(got, f) == getattr(want, f), f
    if prefix_cache:
        assert got.cache_hit_blocks > 0 and got.cache_cow_blocks >= 1


@pytest.fixture(scope="module")
def bridged_quant(tmp_path_factory):
    """Smoke-size opus-mt compressed by the reference with the paper's
    quantization-only baseline (uniform W4, packed where the packing rule
    allows), saved, and read back by the port."""
    cfg = j_get_config("opus-mt", smoke=True)
    params = jtfm.init_params(jax.random.PRNGKey(1), cfg)
    plan = jplan.CompressionPlan.uniform(params, method="quant", weight_wl=4)
    jeng = jengine.InferenceEngine.build(cfg, plan, params=params)
    path = tmp_path_factory.mktemp("ckpt_quant")
    ckpt.save(str(path), 0, jeng.params)
    return cfg, jeng.params, bridge.load_checkpoint(str(path))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_quant_only_serve_is_token_identical_to_reference(bridged_quant,
                                                          kv_bits):
    """Every linear on quant_matmul (packed W4): the port's CPU serve gives
    the reference engine's greedy tokens and scheduling counters."""
    cfg, jparams, tparams = bridged_quant
    leaves = flatten(tparams).values()
    quant = [q for q in leaves if isinstance(q, QuantizedTensor)]
    assert quant and not any(isinstance(q, LowRankQ) for q in leaves)
    assert any(q.packed for q in quant)
    want = jengine.InferenceEngine(
        dataclasses.replace(cfg, kv_cache_bits=kv_bits), jparams,
        max_batch=3, block_size=4, chunk_tokens=8).serve(
            _shared_workload(cfg.vocab_size),
            jengine.SamplingParams(max_tokens=5))
    got = tengine.InferenceEngine.build(
        t_get_config("opus-mt", smoke=True), None, params=tparams,
        device="cpu", kv_bits=kv_bits, max_batch=3, block_size=4,
        chunk_tokens=8).serve(_shared_workload(cfg.vocab_size),
                              tengine.SamplingParams(max_tokens=5))
    for i, (a, b) in enumerate(zip(got.outputs, want.outputs)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    for f in ("steps", "prefill_chunks", "mixed_steps", "cache_hit_blocks"):
        assert getattr(got, f) == getattr(want, f), f


def _mixed_plan(params):
    """ITERA W4 (rank fraction 0.5) for every attention and MLP linear,
    quant W8 for the lm head: both matmul kernels in one engine."""
    base = tplan.CompressionPlan.uniform(
        params, method="itera", weight_wl=4, rank_fraction=0.5,
        exclude=r"(embed|norm|ln|lm_head)")
    return base.replace(layers=base.layers + (
        tplan.LayerPlan("lm_head", "quant", 8),), label="mixed")


def test_mixed_plan_serves_on_cpu_through_the_cli(tmp_path, capsys):
    cfg = t_get_config("opus-mt", smoke=True)
    plan = _mixed_plan(ttfm.init_params(cfg))
    assert [lp.method for lp in plan.layers].count("quant") == 1
    path = tmp_path / "plan.json"
    plan.save(str(path))
    res = tserve.main(["--arch", "opus-mt", "--smoke", "--plan", str(path),
                       "--device", "cpu", "--batch", "5", "--max-batch", "2",
                       "--prompt-len", "14", "--gen", "3", "--kv-bits", "8",
                       "--ragged"])
    assert [o.size for o in res.outputs] == [3] * 5
    assert res.prompt_lens == [14, 10, 6, 4, 14]
    out = capsys.readouterr().out
    assert "itera_W4x6" in out and "quant_W8x1" in out


def test_engine_runs_on_cuda_unless_told_otherwise():
    """No silent CPU fallback: with no GPU, an engine built without an
    explicit device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.InferenceEngine.build("opus-mt", None, smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "opus-mt", "--smoke", "--batch", "1"])


def test_port_imports_neither_jax_nor_the_reference():
    """Statically, no module of the port (nor chip_smoke.py) imports jax
    or `repro`; and importing the engine in a fresh interpreter loads
    neither."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (f, n)
    code = ("import sys; import repro_torch.api.engine, repro_torch.bridge, "
            "repro_torch.launch.serve, repro_torch.core.sra, "
            "repro_torch.data.pipeline, repro_torch.runtime.graphs, "
            "repro_torch.api, repro_torch.hw.dse, repro_torch.hw.h100_model, "
            "repro_torch.hw.engine_model, repro_torch.optim.adamw, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.runtime.fault, repro_torch.checkpoint.ckpt, "
            "repro_torch.models.moe, repro_torch.configs.phi3_medium_14b, "
            "repro_torch.configs.stablelm_12b, "
            "repro_torch.configs.gemma2_9b, repro_torch.kernels.lowrank_qmm, "
            "repro_torch.configs.nemotron_4_340b, "
            "repro_torch.configs.chameleon_34b, "
            "repro_torch.configs.musicgen_medium, repro_torch.runtime.prng, "
            "repro_torch.models.mamba, repro_torch.configs.falcon_mamba_7b, "
            "repro_torch.configs.zamba2_2p7b, repro_torch.runtime.shardctx, "
            "repro_torch.launch.mesh, repro_torch.launch.sharding; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONPATH": str(REPO / "src")},
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, the chip check fails and
    prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], capture_output=True,
                           text=True, cwd=script.parent, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

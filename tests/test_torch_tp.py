"""Tensor-parallel serving in the port (`repro_torch.runtime.shardctx`,
`launch.mesh`, `launch.sharding`, the head-sliced pool, the reduction
sites of `apply_linear`, `InferenceEngine.build(mesh=...)` and the serve
CLI's --mesh) against the JAX reference's shard_map path.

Rank processes run over gloo on the CPU (`launch.mesh.spawn`, one time
limit a spawn, so a rank that hangs fails its test instead of the
suite); their rank functions are in `torch_tp_ranks.py`, which imports
no jax. Weights are the reference's (seed-0 smoke opus-mt, compressed by
the reference where a plan is named) moved with `repro_torch.bridge`,
and the tokens are held to the reference's single-device engine, or to
its shard_map engine for a plan that compresses the K-sites (run in a
subprocess with 8 host devices, as tests/test_tp_serving.py runs it).
Each mesh size's cases run in one spawn, in a module fixture."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tp_ranks as ranks

from repro.api import engine as jengine
from repro.api import plan as jplan
from repro.checkpoint import ckpt as jck
from repro.configs import get_config as j_get_config
from repro.core.compress import CompressionConfig as JCompressionConfig
from repro.core.compress import shape_spectra as j_shape_spectra
from repro.kernels import ops as jops
from repro.launch import sharding as jshd
from repro.models import transformer as jtfm
from repro.runtime import kvblocks as jkv
from repro_torch import bridge
from repro_torch.api import engine as tengine
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.compress import flatten
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import sharding as tshd
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.runtime import kvblocks as tkv
from repro_torch.runtime.speculation import DraftSpec

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1). The rank
# processes take this process's count.
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GEOMETRY = dict(max_batch=3, block_size=4, chunk_tokens=8)
MATRIX = [(dtype, kv) for dtype in ("float32", "bfloat16") for kv in (16, 8)]
SPAWN_S = 300.0          # a spawn's time limit
EXCLUDE = r"(embed|norm|ln|lm_head)"    # chip_smoke.py's plans


def _port(tree):
    """A reference parameter tree (compressed or not) as the port's."""
    flat = jck._flatten(tree)
    return bridge.from_flat(flat, jck._quant_formats(tree),
                            dtypes={k: str(v.dtype) for k, v in flat.items()})


def _cfgs(dtype="float32", kv=16):
    over = dict(dtype=dtype, kv_cache_bits=kv)
    return (dataclasses.replace(j_get_config("opus-mt", smoke=True), **over),
            dataclasses.replace(t_get_config("opus-mt", smoke=True), **over))


def _prompts(seed, lens, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _mixed(params):
    """ITERA W4A8 at rank fraction 0.5 on every layer linear, the lm head
    W8A8: the plan chip_smoke.py serves, K-sites compressed."""
    base = jplan.CompressionPlan.uniform(params, method="itera", weight_wl=4,
                                         rank_fraction=0.5, exclude=EXCLUDE)
    return base.replace(layers=base.layers + (
        jplan.LayerPlan("lm_head", "quant", 8),))


def _plans(params):
    """{name: reference plan or None} of the rules test."""
    return {"dense": None,
            "quant": jplan.CompressionPlan.uniform(params, method="quant",
                                                   weight_wl=4,
                                                   exclude=EXCLUDE),
            "itera mixed": _mixed(params),
            "svd N-sites": jplan.CompressionPlan.from_config(
                params, JCompressionConfig(
                    method="svd", weight_wl=8, rank_fraction=0.75,
                    include=r"/(wq|wk|wv|gate|up)$"))}


@pytest.fixture(scope="module")
def ref_params():
    return jtfm.init_params(jax.random.PRNGKey(0), _cfgs()[0])


@pytest.fixture(scope="module")
def compressed(ref_params):
    """{plan name: (reference params, port params)}, compressed by the
    reference."""
    out = {}
    for name, plan in _plans(ref_params).items():
        jp = ref_params if plan is None else jengine.InferenceEngine.build(
            _cfgs()[0], plan, params=ref_params).params
        out[name] = (jp, _port(jp))
    return out


# ------------------------------------------------------------- the rules --
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("plan", ["dense", "quant", "itera mixed",
                                  "svd N-sites"])
def test_tp_rules_match_the_reference(compressed, plan, tp):
    """Every tensor of the served params takes the reference's action on
    the reference's axis, and tp_shard_params hands each rank the slice
    the reference's spec names."""
    jp, tp_params = compressed[plan]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        p = jshd.path_str(path)
        spec = tuple(jshd.tp_spec_for(p, leaf, tp))
        dim = spec.index("model") if "model" in spec else None
        want[p] = (dim, np.asarray(leaf))
    got = tshd.tp_param_specs(tp_params, tp)
    assert sorted(got) == sorted(want)
    tensors = [_tensors(tshd.tp_shard_params(tp_params, tp, r))
               for r in range(tp)]
    for p, (dim, arr) in want.items():
        action, axis = got[p]
        assert axis == dim, (p, action, axis, dim)
        assert action == ("rep" if dim is None else
                          "col" if dim == arr.ndim - 1 else "row"), p
        for r in range(tp):
            part = tensors[r][p].numpy()
            if dim is None:
                ref = arr
            else:
                n = arr.shape[dim] // tp
                ref = np.take(arr, range(r * n, (r + 1) * n), axis=dim)
            np.testing.assert_array_equal(part, ref, err_msg=p)


def _tensors(params) -> dict:
    """{path: tensor} of a port tree, compressed nodes' arrays under the
    reference's field names."""
    return {p: t for path, leaf in flatten(params).items()
            for p, t in tshd._tensors(path, leaf).items()}


def test_tp_rules_unit():
    """The reference's unit cases of the rules, as (action, dim)."""
    z = torch.zeros
    cases = [("layers/attn/wq", (2, 64, 64), ("col", 2)),
             ("layers/attn/wo", (2, 64, 64), ("row", 1)),
             ("layers/mlp/up", (2, 64, 256), ("col", 2)),
             ("layers/mlp/down", (2, 256, 64), ("row", 1)),
             ("layers/attn/wq/values", (2, 64, 64), ("col", 2)),
             ("layers/attn/wq/scale", (2, 1, 64), ("col", 2)),
             ("layers/mlp/down/values", (2, 256, 64), ("row", 1)),
             ("layers/mlp/down/scale", (2, 1, 64), ("rep", None)),
             ("layers/attn/wk/w1/values", (2, 64, 48), ("rep", None)),
             ("layers/attn/wk/w1/scale", (2, 1, 48), ("rep", None)),
             ("layers/attn/wk/w2/values", (2, 48, 64), ("col", 2)),
             ("layers/attn/wk/w2/scale", (2, 48, 1), ("rep", None)),
             ("layers/mlp/down/w1/values", (2, 256, 48), ("row", 1)),
             ("layers/mlp/down/w2/values", (2, 48, 64), ("rep", None)),
             ("embed", (100, 64), ("rep", None)),
             ("lm_head", (64, 100), ("rep", None)),
             ("final_norm/gamma", (64,), ("rep", None))]
    for path, shape, want in cases:
        assert tshd.tp_spec_for(path, z(shape), 2) == want, path
    assert tshd.tp_spec_for("layers/attn/wq", z((2, 64, 64)), 1) == \
        ("rep", None)
    with pytest.raises(ValueError, match=r"layers/mlp/up"):
        tshd.tp_spec_for("layers/mlp/up", z((2, 64, 250)), 4)
    with pytest.raises(ValueError, match=r"out of range"):
        tshd.tp_shard_params({}, 2, 2)


@pytest.mark.parametrize("case", ["gqa", "heads", "ssm", "hybrid", "moe"])
def test_tp_geometry_errors_match_the_reference(case):
    """check_tp_geometry raises the reference's errors, text for text."""
    jc, tc = _cfgs()
    over = {"gqa": dict(num_kv_heads=2), "heads": dict(num_heads=6,
                                                       num_kv_heads=6),
            "ssm": dict(layout="ssm"), "hybrid": dict(layout="hybrid"),
            "moe": dict(layout="moe")}[case]
    jc, tc = (dataclasses.replace(c, **over) for c in (jc, tc))
    for tp in (1, 2) if case in ("gqa", "heads") else (1,):
        tshd.check_tp_geometry(tc, tp)      # divides: no error
    tp = 4 if case in ("gqa", "heads") else 2
    errors = []
    for check, c in ((jshd.check_tp_geometry, jc),
                     (tshd.check_tp_geometry, tc)):
        with pytest.raises((ValueError, NotImplementedError)) as e:
            check(c, tp)
        errors.append(e)
    (je, te) = errors
    assert te.type is je.type
    if case == "gqa":
        assert "ModelConfig.num_kv_heads=2" in str(te.value)
        assert "no GSPMD padding" in str(te.value)
    elif case == "heads":
        assert "num_heads=6" in str(te.value)
    else:
        assert str(te.value) == str(je.value)
        assert "layout='dense'" in str(te.value)


# -------------------------------------------------------------- the pool --
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("kv", [16, 8])
def test_shard_pool_matches_the_reference(kv, tp):
    """shard_pool is the reference's slice on fp32 and int8 pools; each
    rank's own pool (init_paged_cache of the per-rank config) has its
    shapes and dtypes, and the reference slices the axis it does."""
    jc, tc = _cfgs(kv=kv)
    rng = np.random.default_rng(kv + tp)
    ref = jkv.init_paged_cache(jc, 5, 4)
    pool = {k: rng.integers(-100, 100, v.shape).astype(v.dtype)
            if v.dtype == jnp.int8 else
            rng.standard_normal(v.shape).astype(np.float32)
            for k, v in ref.items()}
    # the reference slices every pool leaf on its KV-head axis 3, the axis
    # shard_pool slices
    jspecs = jkv.pool_pspecs(jc)
    assert set(jspecs) == set(pool)
    assert all(tuple(s).index("model") == 3 for s in jspecs.values())
    local = tkv.init_paged_cache(tshd.tp_local_config(tc, tp), 5, 4, "cpu")
    for r in range(tp):
        want = jkv.shard_pool({k: jnp.asarray(v) for k, v in pool.items()},
                              tp, r)
        got = tkv.shard_pool({k: torch.from_numpy(v)
                              for k, v in pool.items()}, tp, r)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert tuple(local[k].shape) == tuple(got[k].shape)
            assert local[k].dtype == got[k].dtype
    with pytest.raises(ValueError, match="out of range"):
        tkv.shard_pool(pool, tp, tp)


# ---------------------------------------------------- the K-site partials --
def _ref_slice(node, path, tp, r):
    """The reference node `node` (one layer's leaf) with each array sliced
    to rank r by the reference's own spec."""
    def one(p, leaf):
        spec = tuple(jshd.tp_spec_for(f"{path}/{jshd.path_str(p)}".rstrip(
            "/"), leaf, tp))
        if "model" not in spec:
            return leaf
        dim = spec.index("model")
        n = leaf.shape[dim] // tp
        return jax.lax.slice_in_dim(leaf, r * n, (r + 1) * n, axis=dim)

    return jax.tree_util.tree_map_with_path(one, node)


K_SITES = {"itera": ("itera mixed", "down"), "quant": ("quant", "down"),
           "dense": ("dense", "down"), "itera wo": ("itera mixed", "wo")}


def _k_site(compressed, kind):
    plan, name = K_SITES[kind]
    jp, tp_params = compressed[plan]
    group = "mlp" if name == "down" else "attn"
    jnode = jax.tree_util.tree_map(lambda a: a[0], jp["layers"][group][name])
    tnode = ttfm.split_layers(tp_params, 2)["layers"][0][group][name]
    return f"layers/{group}/{name}", jnode, tnode


def _rank_node(path, tnode, tp, r):
    """Rank r's slice of the port's node `tnode` at tree path `path`."""
    _, group, name = path.split("/")
    tree = {"layers": {group: {name: tnode}}}
    return tshd.tp_shard_params(tree, tp, r)["layers"][group][name]


def _x(k, seed=9):
    return np.random.default_rng(seed).standard_normal((6, k)).astype(
        np.float32)


def _ref_partial(x, node):
    if isinstance(node, jax.Array):
        return np.asarray(jnp.matmul(jnp.asarray(x), node,
                                     preferred_element_type=jnp.float32))
    fn = jops.lrmm if hasattr(node, "w1") else jops.qmm
    return np.asarray(fn(jnp.asarray(x), node, use_kernel=False,
                         out_dtype=jnp.float32))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", list(K_SITES))
def test_k_site_partials_equal_the_reference(compressed, kind, tp):
    """Each rank's K-site partial -- apply_linear on the rank's slice of
    the activations and of the LowRankQ / QuantizedTensor / dense weight,
    float32 out, the product the reduction site all-reduces -- equals the
    reference's kops.lrmm / kops.qmm(use_kernel=False) (or its float32
    matmul) on the same slices, bit for bit."""
    path, jnode, tnode = _k_site(compressed, kind)
    k = (jnode.w1.shape if hasattr(jnode, "w1") else jnode.shape)[0]
    x = _x(k)
    n = k // tp
    for r in range(tp):
        jr = _ref_slice(jnode, path, tp, r)
        tr = _rank_node(path, tnode, tp, r)
        xr = x[:, r * n:(r + 1) * n]
        want = _ref_partial(xr, jr)
        with torch.inference_mode():
            if isinstance(tr, torch.Tensor):
                got = torch.from_numpy(xr) @ tr.to(torch.float32)
            else:
                got = tlayers.apply_linear(torch.from_numpy(xr), tr,
                                           out_dtype=torch.float32)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"rank {r}")


def test_k_site_reduction_over_two_ranks(compressed):
    """At tp 2, apply_linear(..., reduce_tp=True) in two gloo rank
    processes returns the sum of the reference's two partials, bit for
    bit, for each kind of weight."""
    sites, xs, want = {}, {}, {}
    for kind in ("itera", "quant", "dense"):
        path, jnode, tnode = _k_site(compressed, kind)
        assert path == "layers/mlp/down"
        k = (jnode.w1.shape if hasattr(jnode, "w1") else jnode.shape)[0]
        x = _x(k)
        parts = [_ref_partial(x[:, r * k // 2:(r + 1) * k // 2],
                              _ref_slice(jnode, path, 2, r))
                 for r in range(2)]
        sites[kind], xs[kind] = tnode, torch.from_numpy(x)
        want[kind] = parts[0] + parts[1]
    got = tmesh.spawn(ranks.reduced_partials, 2, xs, sites,
                      devices=["cpu"] * 2, timeout=SPAWN_S)
    for kind in want:
        np.testing.assert_array_equal(got[kind].numpy(), want[kind],
                                      err_msg=kind)


# ------------------------------------------------------ engines over gloo --
@pytest.fixture(scope="module")
def served(compressed, tmp_path_factory):
    """The port's TP engines in gloo rank processes at tp 1, 2 and 4 (one
    spawn each), and what the reference gives for each case:
    {tp: {case: (port outputs, counters, reference outputs)}}."""
    cases, want = {}, {}
    sp6 = tengine.SamplingParams(max_tokens=6)
    prompts = _prompts(0, (5, 11, 3, 16, 8))
    for dtype, kv in MATRIX:
        jc, tc = _cfgs(dtype, kv)
        jp = jtfm.init_params(jax.random.PRNGKey(0), jc)
        name = f"{dtype} kv{kv}"
        want[name] = jengine.InferenceEngine.build(
            jc, params=jp, **GEOMETRY).serve(
                prompts, jengine.SamplingParams(max_tokens=6)).outputs
        cases[name] = dict(cfg=tc, params=_port(jp), prompts=prompts,
                           sampling=sp6, mode="serve", build=GEOMETRY)
    # speculation: the reference's svd plan on the N-sites of shaped
    # weights, compressed by the reference; its plain engine's tokens
    jc, tc = _cfgs()
    shaped = j_shape_spectra(jtfm.init_params(jax.random.PRNGKey(0), jc),
                             alpha=3.0)
    svd = jplan.CompressionPlan.from_config(shaped, JCompressionConfig(
        method="svd", weight_wl=8, rank_fraction=0.75,
        include=r"/(wq|wk|wv|gate|up)$"))
    jeng = jengine.InferenceEngine.build(jc, svd, params=shaped, **GEOMETRY)
    spec_prompts = _prompts(2, (5, 11, 3, 16, 8))
    want["speculative"] = jeng.serve(
        spec_prompts, jengine.SamplingParams(max_tokens=8)).outputs
    spec = dict(cfg=tc, params=_port(jeng.params), prompts=spec_prompts,
                sampling=tengine.SamplingParams(max_tokens=8), mode="serve",
                build=dict(GEOMETRY, speculate=DraftSpec(
                    k=4, rank_fraction=0.25)))
    # ragged generate (through serve) on other weights
    jp3 = jtfm.init_params(jax.random.PRNGKey(3), jc)
    ragged = _prompts(3, (7, 13, 4))
    want["ragged generate"] = jengine.InferenceEngine.build(
        jc, params=jp3).generate(ragged,
                                 jengine.SamplingParams(max_tokens=5)).tokens
    # rectangular generate: the port's own single-device engine
    rect = np.stack(_prompts(4, (12,) * 3))
    solo = tengine.InferenceEngine.build(tc, params=_port(jp3), device="cpu")
    want["rectangular generate"] = solo.generate(
        rect, tengine.SamplingParams(max_tokens=6)).tokens
    # sampled serve: the reference's single-device engine
    samp = tengine.SamplingParams(max_tokens=6, temperature=0.8, top_k=20,
                                  top_p=0.9, seed=7)
    want["sampled"] = jengine.InferenceEngine.build(
        jc, params=jtfm.init_params(jax.random.PRNGKey(0), jc)).serve(
            [list(range(1, 8)), list(range(3, 15)), [5, 4, 3]],
            jengine.SamplingParams(**samp.to_dict())).outputs
    # the ITERA mixed plan, K-sites compressed: the reference's shard_map
    # engine at tp 2
    path = str(tmp_path_factory.mktemp("mixed"))
    want["itera mixed"] = _reference_tp_serve(path)
    extra = {
        2: {"speculative": spec,
            "ragged generate": dict(cfg=tc, params=_port(jp3),
                                    prompts=ragged, mode="generate",
                                    sampling=tengine.SamplingParams(
                                        max_tokens=5)),
            "rectangular generate": dict(
                cfg=tc, params=_port(jp3), prompts=rect, mode="generate",
                sampling=tengine.SamplingParams(max_tokens=6)),
            "sampled": dict(cfg=tc, params=compressed["dense"][1],
                            prompts=[np.arange(1, 8), np.arange(3, 15),
                                     np.array([5, 4, 3])],
                            sampling=samp, mode="serve"),
            "itera mixed": dict(cfg=tc, params=bridge.load_checkpoint(path),
                                prompts=_prompts(5, (5, 11, 3, 16, 8)),
                                sampling=sp6, mode="serve", build=GEOMETRY)},
        4: {"speculative": spec}}
    out = {}
    for tp in (1, 2, 4):
        got = tmesh.spawn(ranks.run_cases, tp, {**cases, **extra.get(tp, {})},
                          devices=["cpu"] * tp, timeout=SPAWN_S)
        out[tp] = {name: (*got[name], want[name]) for name in got}
    return out


def _reference_tp_serve(path):
    """The reference's shard_map engine at tp 2 serving the mixed plan on
    seed-0 smoke weights (8 host devices, in a subprocess); its compressed
    weights are saved under `path` for the port."""
    code = textwrap.dedent(f"""
        import json
        import numpy as np
        import jax
        from repro.api import plan as jplan
        from repro.api.engine import InferenceEngine, SamplingParams
        from repro.checkpoint import ckpt
        from repro.configs import get_config
        from repro.launch.mesh import make_serving_mesh
        from repro.models import transformer as tfm

        cfg = get_config("opus-mt", smoke=True)
        params = tfm.init_params(jax.random.PRNGKey(0), cfg)
        base = jplan.CompressionPlan.uniform(params, method="itera",
                                             weight_wl=4, rank_fraction=0.5,
                                             exclude={EXCLUDE!r})
        plan = base.replace(layers=base.layers + (
            jplan.LayerPlan("lm_head", "quant", 8),))
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
                   for n in (5, 11, 3, 16, 8)]
        eng = InferenceEngine.build(cfg, plan, params=params,
                                    mesh=make_serving_mesh(2), max_batch=3,
                                    block_size=4, chunk_tokens=8)
        ckpt.save({path!r}, 0, jax.device_get(eng.params))
        res = eng.serve(prompts, SamplingParams(max_tokens=6))
        assert res.mixed_steps > 0
        print(json.dumps([o.tolist() for o in res.outputs]))
        """)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return [np.asarray(o, np.int32) for o in
            json.loads(r.stdout.strip().splitlines()[-1])]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("dtype,kv", MATRIX)
def test_tp_serve_matrix_equals_the_reference(served, dtype, kv, tp):
    """The reference's matrix: greedy serve at tp 1 / 2 / 4 over gloo gives
    the reference single-device engine's tokens, fp32 and bf16, kv 16 and
    8, with chunked prefill overlapping decode (mixed steps)."""
    got, counters, want = served[tp][f"{dtype} kv{kv}"]
    assert counters["mixed_steps"] > 0
    assert _same(got, want)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_speculative_equals_the_reference(served, tp):
    """Speculative TP (the svd plan on the N-sites, DraftSpec(k=4,
    rank_fraction=0.25)) gives the reference plain engine's tokens, with
    drafts made."""
    got, counters, want = served[tp]["speculative"]
    assert counters["drafted"] > 0 and counters["spec_rounds"] > 0
    assert _same(got, want)


@pytest.mark.parametrize("case", ["ragged generate", "rectangular generate",
                                  "sampled", "itera mixed"])
def test_tp2_cases(served, case):
    """At tp 2: ragged generate (through serve) == the reference engine's;
    rectangular generate (prefill and decode over a head-sliced cache, the
    same two all-reduces a layer) == the port's single-device engine;
    seeded sampled serve == the reference engine's; and the ITERA mixed
    plan with compressed K-sites (activations requantized over each rank's
    features) == the reference's shard_map engine at tp 2."""
    got, _, want = served[2][case]
    if isinstance(got, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert _same(got, want)


# ------------------------------------------------------------- the mesh --
def test_serving_mesh_errors():
    """make_serving_mesh refuses what the reference refuses, and never
    picks a backend or device the caller did not name."""
    with pytest.raises(ValueError, match=r">= 1"):
        tmesh.make_serving_mesh(0)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=r"serving mesh needs 2 "
                                             r"devices, have 0"):
            tmesh.make_serving_mesh(2)
    with pytest.raises(ValueError, match=r"serving mesh needs 3 devices, "
                                         r"have 2"):
        tmesh.make_serving_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match=r"backend='gloo'"):
        tmesh.resolve_devices(2, ["cuda:0"] * 2)
    with pytest.raises(ValueError, match=r"'nccl' reduces CUDA"):
        tmesh.resolve_devices(2, ["cpu"] * 2, "nccl")
    assert tmesh.resolve_devices(2, ["cpu"] * 2)[1] == "gloo"
    assert tmesh.resolve_devices(2, ["cuda:0"] * 2, "gloo")[1] == "gloo"
    with pytest.raises(RuntimeError, match=r"process group of 2 ranks"):
        tmesh.make_serving_mesh(2, devices=["cpu"] * 2)


def test_serving_mesh_of_one_in_process():
    """N == 1 is legal in a process with no group: a group of one over an
    in-process store, and an engine on it serves the single-device
    tokens."""
    import torch.distributed as dist

    _, tc = _cfgs()
    prompts = _prompts(6, (5, 9))
    sp = tengine.SamplingParams(max_tokens=4)
    solo = tengine.InferenceEngine.build(tc, device="cpu", **GEOMETRY)
    try:
        mesh = tmesh.make_serving_mesh(1, devices=["cpu"])
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        # the engine runs on the mesh's device, whatever `device` says
        eng = tengine.InferenceEngine.build(tc, mesh=mesh, device="cuda",
                                            **GEOMETRY)
        assert eng.device == torch.device("cpu")
        assert _same(eng.serve(prompts, sp).outputs,
                     solo.serve(prompts, sp).outputs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_engine_refuses_gloo_graph_capture_on_cuda():
    """A gloo mesh on a CUDA device with cuda_graphs=True raises (its
    all-reduce goes through the host and cannot be captured); nothing
    falls back to eager behind the caller's back."""
    _, tc = _cfgs()
    mesh = tmesh.ServingMesh(None, 0, 1, torch.device("cuda:0"), "gloo")
    with pytest.raises(ValueError, match=r"cuda_graphs=False"):
        tengine.InferenceEngine(tc, {}, device=torch.device("cuda:0"),
                                mesh=mesh)


def test_spawn_fails_fast_on_a_failed_or_hung_rank():
    """A rank that raises fails the spawn with its traceback while the
    other rank waits in a collective; a rank that hangs is killed at the
    time limit."""
    with pytest.raises(RuntimeError, match=r"rank 1 fails here"):
        tmesh.spawn(ranks.fail_on_rank_one, 2, devices=["cpu"] * 2,
                    timeout=SPAWN_S)
    with pytest.raises(TimeoutError, match=r"killed"):
        tmesh.spawn(ranks.hang, 2, devices=["cpu"] * 2, timeout=15)


# ---------------------------------------------------------------- the CLI --
def test_serve_cli_mesh(capfd):
    """--mesh 2 (two CPU ranks over gloo) prints and returns the tokens of
    --mesh 0, ragged and rectangular; --mesh with a non-dense arch is
    refused with the reference's error."""
    base = ["--arch", "opus-mt", "--smoke", "--device", "cpu", "--batch",
            "3", "--gen", "5", "--prompt-len", "12"]
    for mode in (["--ragged"], []):
        solo = tserve.main(base + mode)
        capfd.readouterr()
        tp = tserve.main(base + mode + ["--mesh", "2"])
        out = capfd.readouterr().out
        if mode:
            assert _same(tp.outputs, solo.outputs)
            sample = solo.outputs[0][:16].tolist()
        else:
            np.testing.assert_array_equal(tp.tokens, solo.tokens)
            sample = solo.tokens[0][:16].tolist()
        assert "model=2" in out
        assert out.count(f"[serve] sample: {sample}") == 1
    with pytest.raises(NotImplementedError, match=r"layout='dense' only"):
        tserve.main(["--arch", "falcon-mamba-7b", "--smoke", "--device",
                     "cpu", "--mesh", "2"])

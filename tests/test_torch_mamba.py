"""The Mamba layouts in the port -- falcon-mamba-7b (layout "ssm", Mamba1
blocks) and zamba2-2.7b (layout "hybrid", Mamba2 blocks and a shared
attention + MLP block after every `hybrid_period` of them) -- against the
reference on the same weights.

The smoke configs run in float32 and, as the full configs' dtype, in
bfloat16, from the reference's seed-0 weights, dense or compressed by the
reference (ITERA W4 at rank fraction 0.5, quantization-only W4A8), saved
with its checkpoint module and read by `repro_torch.bridge`. The
reference runs jitted. Inputs are numpy-seeded.

Tolerances: the port takes exp, log1p and the state's contraction with C
from float64 (the card and the CPU round them alike), XLA's CPU code takes
them in float32, and its exp and log1p are not correctly rounded (they
differ from the float64 value's rounding in about 9% and 23% of float32
inputs), so the float32 SSM state differs in its last bits; every other
rounding point follows the reference's compiled step (fused
multiply-adds, bfloat16 rounding), so a bfloat16 block's output, which
rounds those bits away, is bit-equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import engine as jengine
from repro.api import plan as jplan
from repro.checkpoint import ckpt as jck
from repro.configs import get_config as j_get_config
from repro.core import compress as jcomp
from repro.models import mamba as jm
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.api import engine as tengine
from repro_torch.checkpoint import ckpt as tck
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import compress as tcomp
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import mamba as tm
from repro_torch.models import transformer as ttfm

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

ARCHS = ["falcon-mamba-7b", "zamba2-2.7b"]
DTYPES = ["float32", "bfloat16"]
PLANS = ["dense", "itera", "quant"]
CPU = torch.device("cpu")
# float32: a block's outputs and state (below 1e-6 measured at these
# sizes; the state's inputs differ in the last bit), and a whole model's
# logits and states (1e-4; up to 1.3e-5 measured in zamba2's
# dense model, whose float matmuls sum in another order)
TOL32 = 1e-5
TOL_MODEL = 1e-4
# bfloat16 dense: the port's bfloat16 matmul (torch's CPU kernel) and
# XLA's float32 dot rounded to bfloat16 differ in the last bit of a few
# outputs; logits moved by up to 1.6e-2 in zamba2's smoke model
TOL_BF16_DENSE = 5e-2


def _cfgs(arch, dtype="float32", **over):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype,
                                **over),
            dataclasses.replace(t_get_config(arch, smoke=True), dtype=dtype,
                                **over))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{(arch, dtype, plan): (reference params, port params)}: each smoke
    model dense, under ITERA W4 at rank fraction 0.5 and under
    quantization-only W4A8, compressed by the reference and read back
    through its checkpoint."""
    out = {}
    for arch in ARCHS:
        for dtype in DTYPES:
            cfg, _ = _cfgs(arch, dtype)
            params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
            plans = {"dense": None,
                     "itera": jplan.CompressionPlan.uniform(
                         params, method="itera", weight_wl=4,
                         rank_fraction=0.5),
                     "quant": jplan.CompressionPlan.uniform(
                         params, method="quant", weight_wl=4)}
            for name, plan in plans.items():
                jp = jengine.InferenceEngine.build(cfg, plan,
                                                   params=params).params
                path = tmp_path_factory.mktemp(f"{arch}_{dtype}_{name}")
                jck.save(str(path), 0, jp)
                out[arch, dtype, name] = (jp, bridge.load_checkpoint(
                    str(path)))
    return out


def _np(x):
    """A tensor or jax array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, plan, what, tol32=TOL32):
    """Bit-equal for a bfloat16 compressed model, else within the
    dtype's tolerance."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if dtype == "bfloat16" and plan != "dense":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        tol = tol32 if dtype == "float32" else TOL_BF16_DENSE
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _prompts(vocab, b=3, s=11, seed=5):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_reference(arch, smoke):
    """Every field (SSMConfig's included), the parameter count and the
    layout flags equal the reference's; the full configs keep their
    published widths."""
    jc, tc = j_get_config(arch, smoke=smoke), t_get_config(arch, smoke=smoke)
    want = dataclasses.asdict(jc)
    for name, value in dataclasses.asdict(tc).items():
        assert value == want[name], name
    assert tc.param_count() == jc.param_count()
    assert tc.is_attention_free == jc.is_attention_free == (arch ==
                                                            ARCHS[0])
    assert tc.supports_long_context and jc.supports_long_context
    if not smoke:
        c = tc.ssm
        widths = (tc.d_model, c.d_state, c.d_conv, c.expand, tc.vocab_size,
                  tc.dtype)
        if arch == ARCHS[0]:
            assert widths == (4096, 16, 4, 2, 65024, "bfloat16")
            assert (c.version, c.dt_rank, tc.num_layers) == (1, 256, 64)
        else:
            assert widths == (2560, 64, 4, 2, 32000, "bfloat16")
            assert (c.version, c.head_dim, tc.num_layers, tc.hybrid_period,
                    tc.num_heads, tc.d_ff, tc.mlp_act) == (
                2, 64, 54, 6, 32, 10240, "gelu")


# ranks at rank fraction 0.5 of the full widths (cut in depth only)
FULL_RANKS = {
    "falcon-mamba-7b": (2, {"in_proj": 2048, "out_proj": 2048,
                            "dt_in": 128, "dt_proj": 128, "bc_proj": 16}),
    "zamba2-2.7b": (12, {"zx_proj": 1280, "out_proj": 1280, "bc_in": 64,
                         "dt_lin": 40, "wq": 1280, "wk": 1280, "wv": 1280,
                         "wo": 1280, "up": 1280, "down": 1280}),
}


def _selected(arch, depth, sel):
    """(path, rank) of every leaf a uniform plan selects at the full
    widths and `depth` layers, by the reference and by the port."""
    jc = dataclasses.replace(j_get_config(arch), num_layers=depth)
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                     jc))
    jsel = jcomp.CompressionConfig(**sel)
    tsel = tcomp.CompressionConfig(**sel)
    want = [(p, jsel.rank_for(p, leaf.shape[-2:]))
            for p, leaf in jcomp.eligible_linears(shapes, jsel)]
    meta = {}
    for path, leaf in jcomp.param_leaves_by_path(shapes).items():
        node = meta
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = torch.empty(leaf.shape, device="meta")
    got = [(p, tsel.rank_for(p, leaf.shape[-2:]))
           for p, leaf in tcomp.eligible_linears(meta, tsel)]
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_selects_the_reference_leaves(arch):
    """At the full widths (the chip check's depth) a uniform plan picks the
    reference's leaves at the reference's ranks: every projection, the
    (Di, 32) bc_proj included; not conv_w (Di, 4), nor Mamba1's A_log
    (Di, 16), nor the per-layer vectors. At the full depth both packages
    also select the stacked per-layer vectors D (L, Di or H) and, in
    zamba2, A_log (54, 80), whose L is then >= min_dim 32 (C9): a plan of
    a deeper model must exclude them."""
    depth, ranks = FULL_RANKS[arch]
    sel = dict(rank_fraction=0.5, exclude=r"(embed|norm|ln|lm_head)")
    want, got = _selected(arch, depth, sel)
    assert got == want
    assert {p.split("/")[-1]: r for p, r in got} == ranks
    want, got = _selected(arch, j_get_config(arch).num_layers,
                          dict(rank_fraction=0.5))
    assert got == want
    vectors = {p for p, _ in got} - {f"layers/mixer/{n}" for n in ranks}
    assert {p for p in vectors if "mixer" in p} == (
        {"layers/mixer/D"} if arch == ARCHS[0] else
        {"layers/mixer/D", "layers/mixer/A_log"})


# ---------------------------------------------------------- the blocks --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(dtype, with_tail):
    """The depthwise causal conv and its new tail, bit for bit: float32 as
    XLA's fused multiply-adds, bfloat16 rounding each product and sum."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 9, 40)).astype(np.float32)
    w = rng.standard_normal((40, 4)).astype(np.float32)
    tail = rng.standard_normal((3, 3, 40)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jt = jnp.asarray(tail, jd) if with_tail else None
    tt = torch.from_numpy(tail).to(td) if with_tail else None
    yj, tj = jax.jit(jm._causal_conv)(jnp.asarray(x, jd), jnp.asarray(w, jd),
                                      jt)
    yt, tt = tm._causal_conv(torch.from_numpy(x).to(td),
                             torch.from_numpy(w).to(td), tt)
    np.testing.assert_array_equal(_np(yt), _np(yj))
    np.testing.assert_array_equal(_np(tt), _np(tj))


@pytest.mark.parametrize("engine", ["sequential", "chunked"])
def test_ssm_scan_matches_reference(engine):
    """`_ssm_scan` over given transition terms (12 steps; the chunk of 5
    shrinks to 4, a divisor of 12): the sequential recurrence bit for bit
    (one fused multiply-add a step), the chunked engine's associative
    scan within 1e-6."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 1.0, (2, 12, 6, 4)).astype(np.float32)
    b = rng.standard_normal((2, 12, 6, 4)).astype(np.float32)
    c = rng.standard_normal((2, 12, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)

    def run(scan, xs, h0, einsum):
        return scan(lambda s: (s["a"], s["b"]),
                    lambda h, s: einsum("...dn,...n->...d", h, s["c"]),
                    xs, h0, engine, 5, 12)

    yj, hj = jax.jit(lambda xs, h0: run(jm._ssm_scan, xs, h0, jnp.einsum))(
        {"a": a, "b": b, "c": c}, h0)
    yt, ht = run(tm._ssm_scan, {k: torch.from_numpy(v) for k, v in
                                dict(a=a, b=b, c=c).items()},
                 torch.from_numpy(h0),
                 lambda s, h, c: torch.einsum(s, h.double(), c.double()
                                              ).float())
    if engine == "sequential":
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-6)


def _layer0(models, arch, dtype, plan):
    jp, tp = models[arch, dtype, plan]
    cfg, _ = _cfgs(arch, dtype)
    return (jax.tree_util.tree_map(lambda x: x[0], jp["layers"])["mixer"],
            ttfm.split_layers(tp, cfg.num_layers)["layers"][0]["mixer"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("plan", PLANS)
def test_block_matches_reference(models, arch, dtype, plan):
    """Layer 0's Mamba block on the same input (B 3, S 10): `_apply` (both
    engines), `_prefill` (y and the cache) and two `_step`s from the
    reference's cache. The bfloat16 outputs of compressed blocks are
    bit-equal; the float32 SSM state within TOL32 (see the module
    docstring)."""
    jc, tc = _cfgs(arch, dtype)
    jl, tl = _layer0(models, arch, dtype, plan)
    v = jc.ssm.version
    jf = {n: getattr(jm, f"mamba{v}_{n}") for n in ("apply", "prefill",
                                                     "step")}
    tf = {n: getattr(tm, f"mamba{v}_{n}") for n in ("apply", "prefill",
                                                     "step")}
    rng = np.random.default_rng(11)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x = rng.standard_normal((3, 10, jc.d_model)).astype(np.float32)
    for engine in ("sequential", "chunked"):
        yj = jax.jit(lambda p, x: jf["apply"](p, x, jc, engine=engine))(
            jl, jnp.asarray(x, jd))
        yt = tf["apply"](tl, torch.from_numpy(x).to(td), tc, engine=engine)
        if engine == "sequential":
            _close(yt, yj, dtype, plan, "apply")
        else:       # the associative scan's order: held within a tolerance
            np.testing.assert_allclose(
                _np(yt), _np(yj), rtol=0,
                atol=TOL32 if dtype == "float32" else TOL_BF16_DENSE)
    yj, cj = jax.jit(lambda p, x: jf["prefill"](p, x, jc))(
        jl, jnp.asarray(x, jd))
    yt, ct = tf["prefill"](tl, torch.from_numpy(x).to(td), tc)
    _close(yt, yj, dtype, plan, "prefill y")
    np.testing.assert_array_equal(_np(ct["conv"]), _np(cj["conv"]))
    np.testing.assert_allclose(_np(ct["h"]), _np(cj["h"]), rtol=0, atol=TOL32)
    step = jax.jit(lambda p, x, c: jf["step"](p, x, c, jc))
    for i in range(2):
        x1 = rng.standard_normal((3, 1, jc.d_model)).astype(np.float32)
        yj, cj = step(jl, jnp.asarray(x1, jd), cj)
        cache = {k: torch.from_numpy(np.array(jnp.asarray(v, jnp.float32))
                                     ).to(ct[k].dtype) for k, v in cj.items()}
        yt, ct = tf["step"](tl, torch.from_numpy(x1).to(td), ct, tc)
        _close(yt, yj, dtype, plan, f"step {i} y")
        np.testing.assert_array_equal(_np(ct["conv"]), _np(cj["conv"]))
        np.testing.assert_allclose(_np(ct["h"]), _np(cj["h"]), rtol=0,
                                   atol=TOL32)
        ct = cache              # the next step from the reference's cache


# ----------------------------------------------------------- the model --
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("plan", PLANS)
def test_model_matches_reference(models, arch, dtype, plan):
    """`forward` and `loss_fn`, `prefill` into a longer
    cache ({"ssm"}, and the hybrid's "shared_kv" with one KV cache per
    invocation of the shared block) and two `decode_step`s, the cache
    updated in place: logits and cache leaves against the reference's
    (bit-equal for a compressed bfloat16 model)."""
    jc, tc = _cfgs(arch, dtype)
    jp, tp = models[arch, dtype, plan]
    toks = _prompts(jc.vocab_size, b=2, s=9)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    hj, aj = jax.jit(lambda p, t: jtfm.forward(p, t, jc))(jp, jt)
    ht, at = ttfm.forward(tp, tt, tc)
    assert float(aj) == at == 0.0
    _close(ht, hj, dtype, plan, "forward", TOL_MODEL)
    # the loss is float32 in every dtype (a logsumexp over the vocab)
    labels = np.roll(toks, -1, axis=1)
    lj, _ = jax.jit(lambda p, b: jtfm.loss_fn(p, b, jc))(
        jp, {"tokens": jt, "labels": jnp.asarray(labels)})
    lt, _ = ttfm.loss_fn(tp, {"tokens": tt,
                              "labels": torch.from_numpy(labels)}, tc)
    assert abs(float(lt) - float(lj)) < TOL_MODEL
    lj, cj = jax.jit(lambda p, t: jtfm.prefill(p, t, jc, max_len=12))(jp, jt)
    lt, ct = ttfm.prefill(tp, tt, tc, max_len=12)
    want_tree = {g: sorted(v) for g, v in cj.items()}
    assert {g: sorted(v) for g, v in ct.items()} == want_tree
    empty = ttfm.init_cache(tc, 2, 12)
    for g, leaves in jtfm.init_cache(jc, 2, 12).items():
        for name, leaf in leaves.items():
            assert tuple(empty[g][name].shape) == leaf.shape, (g, name)
            assert tuple(ct[g][name].shape) == leaf.shape, (g, name)
    _close(lt, lj, dtype, plan, "prefill logits", TOL_MODEL)
    step = jax.jit(lambda p, c, t, pos: jtfm.decode_step(p, c, t, pos, jc))
    for pos in (9, 10):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
        held = {g: dict(v) for g, v in ct.items()}
        lj, cj = step(jp, cj, jnp.asarray(tok), jnp.int32(pos))
        lt, ct = ttfm.decode_step(tp, ct, torch.from_numpy(tok), pos, tc)
        _close(lt, lj, dtype, plan, f"decode logits at {pos}",
               TOL_MODEL)
        for g in cj:
            for name in cj[g]:
                assert ct[g][name] is held[g][name]      # updated in place
        np.testing.assert_allclose(_np(ct["ssm"]["h"]), _np(cj["ssm"]["h"]),
                                   rtol=0, atol=TOL_MODEL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_model_chunked_engine_matches_reference(models, arch, dtype):
    """`forward`, `loss_fn` and `prefill` with `ssm_engine="chunked"` on
    the dense model (12 tokens: the chunk shrinks to a divisor of 12)
    against the reference's chunked engine: the associative scan's order
    is the reference's, held within TOL_MODEL in float32 and
    TOL_BF16_DENSE in bfloat16. (Under a compressed plan a last-bit
    difference can move an activation's int8 code, so the float32 model
    is held on its dense weights.)"""
    jc, tc = _cfgs(arch, dtype)
    jp, tp = models[arch, dtype, "dense"]
    toks = _prompts(jc.vocab_size, b=2, s=12, seed=8)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    tol = TOL_MODEL if dtype == "float32" else TOL_BF16_DENSE

    def close(got, want, what):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol,
                                   err_msg=what)

    hj, _ = jax.jit(lambda p, t: jtfm.forward(p, t, jc,
                                              ssm_engine="chunked"))(jp, jt)
    ht, _ = ttfm.forward(tp, tt, tc, ssm_engine="chunked")
    close(ht, hj, "forward")
    labels = np.roll(toks, -1, axis=1)
    lj, _ = jax.jit(lambda p, b: jtfm.loss_fn(p, b, jc,
                                              ssm_engine="chunked"))(
        jp, {"tokens": jt, "labels": jnp.asarray(labels)})
    lt, _ = ttfm.loss_fn(tp, {"tokens": tt,
                              "labels": torch.from_numpy(labels)}, tc,
                         ssm_engine="chunked")
    assert abs(float(lt) - float(lj)) < TOL_MODEL
    lj, cj = jax.jit(lambda p, t: jtfm.prefill(p, t, jc, max_len=14,
                                               ssm_engine="chunked"))(jp, jt)
    lt, ct = ttfm.prefill(tp, tt, tc, max_len=14, ssm_engine="chunked")
    close(lt, lj, "prefill logits")
    close(ct["ssm"]["h"], cj["ssm"]["h"], "prefill state")
    close(ct["ssm"]["conv"], cj["ssm"]["conv"], "prefill conv tail")


# ------------------------------------------------------- the engine --
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("plan", ["itera", "quant"])
def test_generate_matches_reference(models, arch, dtype, plan):
    """`generate` at the prompts' exact length (a Mamba state would take
    a bucket's pads in), greedy and seeded sampled: the reference engine's
    tokens; a second batch through the same engine-held decode cache, and
    the first again, give the same tokens as before."""
    jc, tc = _cfgs(arch, dtype)
    jp, tp = models[arch, dtype, plan]
    je = jengine.InferenceEngine(jc, jp)
    te = tengine.InferenceEngine(tc, tp, device=CPU)
    assert not te.bucket_prompts and not je.bucket_prompts
    a, b = _prompts(jc.vocab_size), _prompts(jc.vocab_size, seed=6)
    for sp in (dict(max_tokens=5),
               dict(max_tokens=5, temperature=0.8, top_k=20, top_p=0.9,
                    seed=3)):
        want = je.generate(a, jengine.SamplingParams(**sp)).tokens
        first = te.generate(a, tengine.SamplingParams(**sp)).tokens
        np.testing.assert_array_equal(first, np.asarray(want), err_msg=sp)
        te.generate(b, tengine.SamplingParams(**sp))
        again = te.generate(a, tengine.SamplingParams(**sp)).tokens
        np.testing.assert_array_equal(again, first)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_refuses_and_training_runs(models, arch, tmp_path):
    """`serve` (and so a ragged `generate`) refuses both layouts as the
    reference's does; a train step and the train CLI take them (their
    gradients against the reference's: tests/test_torch_mamba_train.py);
    the serve CLI generates in lockstep."""
    jc, tc = _cfgs(arch)
    jp, tp = models[arch, "float32", "itera"]
    te = tengine.InferenceEngine(tc, tp, device=CPU)
    prompts = [np.arange(1, 6, dtype=np.int32), np.arange(1, 9,
                                                          dtype=np.int32)]
    for fn in (te.serve, te.generate):
        with pytest.raises(NotImplementedError, match=tc.layout):
            fn(prompts, tengine.SamplingParams(max_tokens=2))
    with pytest.raises(NotImplementedError, match=tc.layout):
        jengine.InferenceEngine(jc, jp).serve(
            prompts, jengine.SamplingParams(max_tokens=2))
    batch = {"tokens": torch.ones((1, 4), dtype=torch.int32),
             "labels": torch.ones((1, 4), dtype=torch.int32)}
    _, dense = models[arch, "float32", "dense"]
    (loss, _), grads = tsteps.loss_and_grads(dense, batch, tc)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in
               tck.flatten(grads).values())
    losses = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--steps", "1", "--batch", "2", "--seq", "8",
                          "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 1 and np.isfinite(losses[0])
    res = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4",
                       "--compression", "itera", "--wl", "4",
                       "--rank-fraction", "0.5"])
    assert res.tokens.shape == (2, 4)
    assert bool(((res.tokens >= 0) & (res.tokens < tc.vocab_size)).all())

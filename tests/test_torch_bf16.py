"""The bfloat16 model dtype of the port (the configs of phi3-medium-14b and
stablelm-12b, bf16 checkpoints through `bridge` and `checkpoint.ckpt`,
the norms, activations and RoPE at bf16, `quantize_acts` of a bf16 x,
the integer kernels' plain versions with a bf16 output, attention at the
reference's bf16 rounding points, and the engine's serve of a bf16
model) against the reference on the same inputs.

The smoke configs are float32 in both packages; the bf16 models here are
the same configs with dtype "bfloat16" (the full configs' dtype), seed-0
weights of the reference, compressed by the reference and moved with
`repro_torch.bridge`. Inputs are numpy-seeded. Every comparison is exact
unless its test states a tolerance."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.api import engine as jengine
from repro.api import plan as jplan
from repro.checkpoint import ckpt as jck
from repro.configs import get_config as j_get_config
from repro.core import compress as jcompress
from repro.core.quant import quantize as jquantize
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.api import engine as tengine
from repro_torch.api import plan as tplan
from repro_torch.checkpoint import ckpt as tck
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.compress import compress_params
from repro_torch.core.quant import quantize as tquantize
from repro_torch.kernels import ops as tops
from repro_torch.kernels.lowrank_qmm import lowrank_qmm, lowrank_qmm_plain
from repro_torch.kernels.paged_attention import span_attend_gather
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_plain
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import split_layers

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

ARCHS = ["phi3-medium-14b", "stablelm-12b"]
BF16 = jnp.bfloat16


def _bf16(a) -> jax.Array:
    return jnp.asarray(np.asarray(a, np.float32)).astype(BF16)


def _t(a) -> torch.Tensor:
    """A reference array as a port tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    """The bf16 values' bit patterns (exact comparison, NaN-safe)."""
    return t.contiguous().view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


def _assert_near_bf16(got: torch.Tensor, want) -> None:
    """At most 0.1% of elements differ, each by at most 2^-7 of the
    largest |value| of its last-axis row (a bf16 ulp of the row's scale)."""
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    diff = np.abs(g - w)
    assert (diff > 0).mean() <= 1e-3
    assert (diff <= 2.0 ** -7 * np.abs(w).max(-1, keepdims=True)).all()


def _bf16_cfg(arch, kv_bits=16):
    return (dataclasses.replace(j_get_config(arch, smoke=True),
                                dtype="bfloat16", kv_cache_bits=kv_bits),
            dataclasses.replace(t_get_config(arch, smoke=True),
                                dtype="bfloat16", kv_cache_bits=kv_bits))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{(arch, plan): (reference params, port params, report, ckpt dir)}:
    the bf16 smoke model under ITERA W4 at rank fraction 0.5 and
    quantization-only W4A8, compressed by the reference and read back
    through its checkpoint; "dense" is the uncompressed tree."""
    out = {}
    for arch in ARCHS:
        cfg, _ = _bf16_cfg(arch)
        params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
        plans = {"dense": None,
                 "itera": jplan.CompressionPlan.uniform(
                     params, method="itera", weight_wl=4,
                     rank_fraction=0.5),
                 "quant": jplan.CompressionPlan.uniform(
                     params, method="quant", weight_wl=4)}
        for name, plan in plans.items():
            jeng = jengine.InferenceEngine.build(cfg, plan, params=params)
            path = tmp_path_factory.mktemp(f"bf16_{arch}_{name}")
            jck.save(str(path), 0, jeng.params)
            out[arch, name] = (jeng.params, bridge.load_checkpoint(str(path)),
                               jeng.report, path)
    return out


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, smoke):
    jc, tc = j_get_config(arch, smoke=smoke), t_get_config(arch, smoke=smoke)
    want = dataclasses.asdict(jc)
    for name, value in dataclasses.asdict(tc).items():
        assert value == want[name], name
    assert tc.param_count() == jc.param_count()
    if not smoke:
        assert tc.dtype == "bfloat16"


# --------------------------------------------------------- checkpoints --
def test_bridge_reads_reference_bf16_checkpoint_byte_for_byte(models):
    """Every array of the reference's bf16 dense checkpoint arrives in
    torch.bfloat16 with the same bytes (never through float32)."""
    jp, tp, _, path = models["phi3-medium-14b", "dense"]
    step = path / "step_00000000"
    manifest = json.loads((step / "manifest.json").read_text())
    assert set(manifest["dtypes"].values()) == {"bfloat16"}
    flat_t = tck.flatten(tp)
    with np.load(step / "arrays.npz") as data:
        assert sorted(flat_t) == sorted(data.files)
        for key in data.files:
            assert flat_t[key].dtype == torch.bfloat16, key
            np.testing.assert_array_equal(_bits(flat_t[key]),
                                          data[key].view(np.int16))


def test_port_bf16_checkpoint_is_the_reference_format(models, tmp_path):
    """The port writes bf16 as the reference does (2-byte void arrays,
    "bfloat16" in the manifest), reads its own and the reference's back
    bit for bit, and `bridge` reads the port's."""
    _, tp, _, path = models["stablelm-12b", "quant"]
    tck.save(str(tmp_path), 0, tp)
    mine, theirs = tmp_path / "step_00000000", path / "step_00000000"
    m_mine = json.loads((mine / "manifest.json").read_text())
    m_theirs = json.loads((theirs / "manifest.json").read_text())
    for field in ("keys", "shapes", "dtypes", "quant_formats"):
        assert m_mine[field] == m_theirs[field], field
    with np.load(mine / "arrays.npz") as a, \
            np.load(theirs / "arrays.npz") as b:
        for key in b.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
    for src in (str(tmp_path), str(path)):
        back, _ = tck.restore(src, tp)
        again = bridge.load_checkpoint(src)
        for tree in (back, again):
            for key, t in tck.flatten(tree).items():
                want = tck.flatten(tp)[key]
                assert t.dtype == want.dtype, key
                assert torch.equal(t.view(torch.int8) if t.dtype ==
                                   torch.bfloat16 else t,
                                   want.view(torch.int8) if want.dtype ==
                                   torch.bfloat16 else want), key


# ------------------------------------------------------------- numerics --
def test_quantize_acts_bf16_matches_reference():
    """Codes and scales of a bf16 x equal the reference's, eager and
    jitted (the jitted step keeps `absmax / qm`'s rounding to bf16)."""
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((96, 320)) * np.exp(
        rng.uniform(-3, 3, (96, 1))))
    for qm in (127, 31):
        xq_t, sx_t = tops.quantize_acts(_t(x), qm)
        for fn in (jops.quantize_acts,
                   jax.jit(jops.quantize_acts, static_argnums=1)):
            xq_j, sx_j = fn(x, qm)
            np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
            np.testing.assert_array_equal(sx_t.numpy(), np.asarray(sx_j))


def test_activations_norms_and_rope_bf16_match_reference():
    """SiLU, GELU, RMSNorm, LayerNorm and RoPE (rotary_pct 1.0 and 0.25)
    of bf16 inputs against the reference's jitted functions: SiLU, GELU
    and RoPE bit-equal; the norms (float64 against float32 rsqrt and mean,
    which meet at a bf16 rounding boundary now and then) differ on at most
    0.1% of elements, each by at most 2^-7 of its row's largest value
    (one bf16 ulp of the normalized value, through gamma and beta)."""
    rng = np.random.default_rng(1)
    x = _bf16(rng.standard_normal((64, 256)) * 3)
    g = _bf16(rng.standard_normal(256) * 0.1)
    b = _bf16(rng.standard_normal(256) * 0.1)
    assert np.array_equal(_bits(tlayers.silu(_t(x))),
                          _jbits(jax.jit(jax.nn.silu)(x)))
    assert np.array_equal(_bits(tlayers.gelu(_t(x))),
                          _jbits(jax.jit(jax.nn.gelu)(x)))
    for got, want in (
            (tlayers.rmsnorm(_t(x), _t(g)), jax.jit(jlayers.rmsnorm)(x, g)),
            (tlayers.layernorm(_t(x), _t(g), _t(b)),
             jax.jit(jlayers.layernorm)(x, g, b))):
        _assert_near_bf16(got, want)
    xr = _bf16(rng.standard_normal((2, 7, 4, 32)))
    pos = np.arange(7)[None].repeat(2, 0) + 5
    for pct in (1.0, 0.25):
        want = jax.jit(lambda a, p, pct=pct: jlayers.apply_rope(
            a, p, 10000.0, pct))(xr, jnp.asarray(pos))
        got = tlayers.apply_rope(_t(xr), torch.tensor(pos), 10000.0, pct)
        assert np.array_equal(_bits(got), _jbits(want)), pct


def test_residual_norm_reads_the_unrounded_sum():
    """`add_norm` at bf16 is the reference's jitted h + a followed by a
    norm (its compiled step drops the add's rounding for the norm, not
    for the residual); at float32 it is the plain sum and norm."""
    rng = np.random.default_rng(2)
    h = _bf16(rng.standard_normal((48, 80)))
    a = _bf16(rng.standard_normal((48, 80)) * 0.3)
    g = _bf16(rng.standard_normal(80) * 0.1)
    bb = _bf16(rng.standard_normal(80) * 0.1)
    for kind, p in (("rmsnorm", {"gamma": g}),
                    ("layernorm", {"gamma": g, "beta": bb})):
        want_s, want_n = jax.jit(lambda h, a, p, kind=kind: (
            h + a, jlayers.apply_norm(h + a, p, kind, 1e-5)))(h, a, p)
        got_s, got_n = tlayers.add_norm(
            _t(h), _t(a), {k: _t(v) for k, v in p.items()}, kind, 1e-5)
        assert np.array_equal(_bits(got_s), _jbits(want_s))
        _assert_near_bf16(got_n, want_n)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dh,g", [(160, 4), (192, 12)])
def test_span_attention_bf16_matches_reference_oracle(dh, g, quant):
    """`span_attend_gather` on a bf16 q over a bf16 pool, or an int8 one
    with fp32 scales, against the reference's `_span_attend_gather` at
    bf16 (every span position of every row, idle rows included), at
    stablelm's Dh 160 with a group of 4 and nemotron's Dh 192 with a
    group of 12: at most 0.1% of elements differ, each by at most 2^-7 of
    its row's largest value (float64 against float32 sums at a bf16
    rounding boundary of p or of the output)."""
    rng = np.random.default_rng(3 if dh == 160 else 3 + dh)
    b, w, hk, bs, mb, nb = 3, 5, 2, 16, 4, 13
    h = hk * g
    q = _bf16(rng.standard_normal((b, w, h, dh)))
    if quant:
        pool = {"k": jnp.asarray(rng.integers(-127, 128, (nb, bs, hk, dh)),
                                 jnp.int8),
                "v": jnp.asarray(rng.integers(-127, 128, (nb, bs, hk, dh)),
                                 jnp.int8),
                "ks": jnp.asarray(rng.uniform(1e-3, 2e-2, (nb, bs, hk, 1)),
                                  jnp.float32),
                "vs": jnp.asarray(rng.uniform(1e-3, 2e-2, (nb, bs, hk, 1)),
                                  jnp.float32)}
    else:
        pool = {"k": _bf16(rng.standard_normal((nb, bs, hk, dh))),
                "v": _bf16(rng.standard_normal((nb, bs, hk, dh)))}
    bt = rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
    bt = bt.astype(np.int32)
    ctx = np.array([0, 21, 50], np.int32)
    cfg = dataclasses.replace(j_get_config("stablelm-12b", smoke=True),
                              num_heads=h, num_kv_heads=hk, head_dim=dh)
    pos = jnp.asarray(ctx)[:, None] + jnp.arange(w)[None]
    want = jax.jit(lambda q, pool: jattn._span_attend_gather(
        q, pool, jnp.asarray(bt), pos, cfg))(q, pool)
    got = span_attend_gather(_t(q), {k: _t(v) for k, v in pool.items()},
                             torch.tensor(bt), torch.tensor(ctx))
    assert got.dtype == torch.bfloat16
    _assert_near_bf16(got, want)


def test_integer_kernels_write_bf16_as_the_reference_casts():
    """The plain versions (and the wrappers on CPU tensors) with a bf16
    output are the reference's float32 result `.astype(bfloat16)`, bit
    for bit; the wrappers refuse any other output dtype."""
    rng = np.random.default_rng(4)
    m, k, r, n = 9, 96, 64, 160
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    sx = rng.uniform(1e-3, 1e-2, (m, 1)).astype(np.float32)
    wq = rng.integers(-7, 8, (k, n)).astype(np.int8)
    sw = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    want = jref.quant_matmul_ref(xq, sx, wq, sw).astype(BF16)
    for fn in (quant_matmul_plain, quant_matmul):
        got = fn(*map(torch.from_numpy, (xq, sx, wq, sw)),
                 out_dtype=torch.bfloat16)
        assert np.array_equal(_bits(got), _jbits(want))
    w1 = rng.integers(-7, 8, (k, r)).astype(np.int8)
    s1 = rng.uniform(1e-2, 1e-1, (1, r)).astype(np.float32)
    w2 = rng.integers(-7, 8, (r, n)).astype(np.int8)
    s2 = rng.uniform(1e-2, 1e-1, (r, 1)).astype(np.float32)
    want = jref.lowrank_qmm_ref(xq, sx, w1, s1, w2, s2, 127).astype(BF16)
    for fn in (lowrank_qmm_plain, lowrank_qmm):
        got = fn(*map(torch.from_numpy, (xq, sx, w1, s1, w2, s2)),
                 out_dtype=torch.bfloat16)
        assert np.array_equal(_bits(got), _jbits(want))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        quant_matmul(*map(torch.from_numpy, (xq, sx, wq, sw)),
                     out_dtype=torch.float16)


@pytest.mark.parametrize("method", ["quant", "itera"])
def test_linears_of_bf16_model_match_reference(models, method):
    """`apply_linear` of a bf16 x through a compressed leaf of the bf16
    model (bf16 output) and through the lm head (float32 output) equals
    the reference's jitted `apply_linear`, bit for bit."""
    jp, tp, _, _ = models["phi3-medium-14b", method]
    rng = np.random.default_rng(5)
    x = _bf16(rng.standard_normal((2, 7, 80)))
    j_up = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mlp"]["up"])
    t_up = split_layers(tp, 2)["layers"][0]["mlp"]["up"]
    want = jax.jit(jlayers.apply_linear)(x, j_up)
    got = tlayers.apply_linear(_t(x), t_up)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got), _jbits(want))
    want = jax.jit(lambda x, w: jlayers.apply_linear(
        x, w, out_dtype=jnp.float32))(x, jp["lm_head"])
    got = tlayers.apply_linear(_t(x), tp["lm_head"], out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["quant", "itera"])
def test_compressing_bf16_weights_matches_reference(models, method):
    """The port compresses the bf16 tree from its float32 upcast (ITERA)
    or as it is (quant), as the reference does: the quant plan's codes and
    scales are the reference's; both plans count the bf16 leaves they
    skip at 16 bits (the reference's `_leaf_bits`), and every compressed
    leaf's storage bits and shape equal the reference's."""
    jp0, tp0, _, _ = models["stablelm-12b", "dense"]
    _, _, jrep, _ = models["stablelm-12b", method]
    tplan_ = tplan.CompressionPlan.from_dict(jrep.plan.to_dict())
    tout, trep = compress_params(tp0, tplan_)
    assert trep.skipped_bits == jrep.skipped_bits
    assert trep.skipped_params == jrep.skipped_params
    got = {r.path: (r.bits, r.shape, r.rank) for r in trep.layers}
    want = {r.path: (r.bits, tuple(r.shape), r.rank) for r in jrep.layers}
    assert got == want
    if method == "quant":
        jq, _ = jcompress.compress_params(jp0, jrep.plan)
        flat_j = jck._flatten(jq)
        for key, t in tck.flatten(tout).items():
            want_a = flat_j[key]
            if want_a.dtype == ml_dtypes.bfloat16:
                assert np.array_equal(_bits(t), want_a.view(np.int16)), key
            else:
                np.testing.assert_array_equal(t.numpy(), want_a, err_msg=key)


def test_quantize_bf16_weight_matches_reference():
    """`quantize` of a bf16 weight: codes and float32 scales (absmax / m
    rounded to bf16, then widened) equal the reference's."""
    rng = np.random.default_rng(6)
    w = _bf16(rng.standard_normal((64, 512)) * 0.05)
    for wl in (4, 8):
        jq, tq = jquantize(w, wl, axis=0), tquantize(_t(w), wl, axis=0)
        np.testing.assert_array_equal(tq.values.numpy(),
                                      np.asarray(jq.values))
        np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))


# --------------------------------------------------------------- serve --
def _requests(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (5, 17, 9, 30)]


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("method", ["itera", "quant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_bf16_matches_reference_engine(models, arch, method, kv_bits):
    """Greedy serve of the bf16 smoke model (4 ragged requests, 6 new
    tokens each) gives the reference engine's tokens, every one of them,
    at kv 16 (a bf16 pool) and kv 8 (int8 codes, fp32 scales)."""
    jp, tp, _, _ = models[arch, method]
    jc, tc = _bf16_cfg(arch, kv_bits)
    reqs = _requests(jc.vocab_size)
    jr = jengine.InferenceEngine.build(jc, None, params=jp).serve(
        reqs, jengine.SamplingParams(max_tokens=6))
    teng = tengine.InferenceEngine.build(tc, None, params=tp, device="cpu")
    assert teng.cfg.dtype == "bfloat16"
    tr = teng.serve([torch.tensor(r) for r in reqs],
                    tengine.SamplingParams(max_tokens=6))
    for a, b in zip(jr.outputs, tr.outputs):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_generate_bf16_matches_reference_engine(models):
    """Rectangular `generate` of the bf16 phi3 smoke model (quant-only):
    prefill and the decode steps give the reference engine's greedy
    tokens."""
    jp, tp, _, _ = models["phi3-medium-14b", "quant"]
    jc, tc = _bf16_cfg("phi3-medium-14b")
    prompts = np.random.default_rng(8).integers(0, 256, (3, 11))
    prompts = prompts.astype(np.int32)
    jr = jengine.InferenceEngine.build(jc, None, params=jp).generate(
        [p for p in prompts], jengine.SamplingParams(max_tokens=6))
    tr = tengine.InferenceEngine.build(tc, None, params=tp,
                                       device="cpu").generate(
        [torch.tensor(p) for p in prompts],
        tengine.SamplingParams(max_tokens=6))
    np.testing.assert_array_equal(np.asarray(tr.tokens),
                                  np.asarray(jr.tokens))


def test_serve_cli_takes_the_bf16_archs(capsys):
    """`launch.serve` serves both new archs by name (smoke, on the CPU);
    the dtype comes from the config, so a full config would be bf16."""
    for arch in ARCHS:
        res = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--ragged", "--gen", "3",
                           "--compression", "quant", "--wl", "4"])
        assert len(res.outputs) == 2
        assert all(len(o) == 3 for o in res.outputs)

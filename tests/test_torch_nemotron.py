"""nemotron-4-340b in the port (squared-ReLU MLP: six linears a layer,
LayerNorm with a bias, half the head dims rotary) against the reference
on the same weights.

The smoke config (2 layers, d_model 96, 6 heads of 16 over 2) runs in
float32 and, as the full config's dtype, in bfloat16, from the
reference's seed-0 weights, compressed by the reference (ITERA W4 at rank
fraction 0.5 and quantization-only W4A8), saved with its checkpoint
module and read by `repro_torch.bridge`. Inputs are numpy-seeded; every
comparison is exact unless its test states a tolerance."""
import dataclasses

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
from repro.core import quant as jquant
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.api import engine as tengine
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import quant as tquant
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.transformer import split_layers

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

ARCH = "nemotron-4-340b"
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype="float32", **over):
    return (dataclasses.replace(j_get_config(ARCH, smoke=True), dtype=dtype,
                                **over),
            dataclasses.replace(t_get_config(ARCH, smoke=True), dtype=dtype,
                                **over))


def _t(a) -> torch.Tensor:
    """A reference array as a port tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _same_bits(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        return np.array_equal(got.contiguous().view(torch.int16).numpy(),
                              want.view(np.int16))
    return np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{(dtype, plan): (reference params, port params)}: the smoke model
    under ITERA W4 at rank fraction 0.5 and quantization-only W4A8,
    compressed by the reference and read back through its checkpoint."""
    out = {}
    for dtype in DTYPES:
        cfg, _ = _cfgs(dtype)
        params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
        plans = {"itera": jplan.CompressionPlan.uniform(
                     params, method="itera", weight_wl=4, rank_fraction=0.5),
                 "quant": jplan.CompressionPlan.uniform(
                     params, method="quant", weight_wl=4)}
        for name, plan in plans.items():
            jp = jengine.InferenceEngine.build(cfg, plan, params=params).params
            path = tmp_path_factory.mktemp(f"nemotron_{dtype}_{name}")
            jck.save(str(path), 0, jp)
            out[dtype, name] = (jp, bridge.load_checkpoint(str(path)))
    return out


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_reference(smoke):
    """Every field the port keeps equals the reference's, and so does the
    parameter count; the full config is bfloat16 at the published widths
    (head dim 18432 / 96 = 192, relu2, LayerNorm, rotary 0.5), within 1%
    of 340e9 parameters."""
    jc, tc = j_get_config(ARCH, smoke=smoke), t_get_config(ARCH, smoke=smoke)
    want = dataclasses.asdict(jc)
    for name, value in dataclasses.asdict(tc).items():
        assert value == want[name], name
    assert tc.param_count() == jc.param_count()
    assert (tc.mlp_act, tc.norm, tc.rotary_pct) == ("relu2", "layernorm",
                                                    0.5)
    if not smoke:
        assert tc.dtype == "bfloat16"
        assert (tc.d_model, tc.num_heads, tc.num_kv_heads, tc.head_dim,
                tc.d_ff, tc.vocab_size) == (18432, 96, 8, 192, 73728,
                                            256000)
        assert abs(tc.param_count() - 340e9) / 340e9 < 0.01


# ------------------------------------------------------------- numerics --
@pytest.mark.parametrize("plan", ["itera", "quant"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_relu2_mlp_and_layernorm_match_reference(models, dtype, plan):
    """The relu2 MLP of layer 0 (up, square(relu(.)), down: two
    compressed linears, no gate) and its LayerNorm with the bias, on the
    same x, against the reference's jitted functions: the MLP bit for bit
    at both dtypes (at bf16 the square rounds to bf16 before `down`
    quantizes it, as the reference's compiled MLP keeps it); the norm
    within 1e-6 at float32 (float64 against float32 moments) and at bf16
    on at most 0.1% of elements, each within 2^-7 of its row's largest
    value."""
    jp, tp = models[dtype, plan]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 9, 96)), jnp.float32).astype(
        jnp.dtype(dtype))
    jmlp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mlp"])
    tl = split_layers(tp, 2)["layers"][0]
    assert sorted(tl["mlp"]) == ["down", "up"]
    want = jax.jit(lambda x, p: jlayers.mlp_apply(x, p, "relu2"))(x, jmlp)
    got = tlayers.mlp_apply(_t(x), tl["mlp"], "relu2")
    assert got.dtype == _t(x).dtype
    assert _same_bits(got, want)
    ln = {k: v[0] for k, v in jp["layers"]["ln2"].items()}
    beta = np.asarray(rng.standard_normal(96) * 0.1, np.float32)
    ln["beta"] = jnp.asarray(beta).astype(jnp.dtype(dtype))
    want = np.asarray(jax.jit(lambda x, p: jlayers.apply_norm(
        x, p, "layernorm", 1e-5))(x, ln)).astype(np.float32)
    got = tlayers.apply_norm(_t(x), {k: _t(v) for k, v in ln.items()},
                             "layernorm", 1e-5).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        diff = np.abs(got - want)
        assert (diff > 0).mean() <= 1e-3
        assert (diff <= 2.0 ** -7 * np.abs(want).max(-1, keepdims=True)).all()


def test_plain_integer_product_has_room_at_the_widest_k():
    """At K 73728 (nemotron's `down`) every int8 x int8 product sum stays
    below 2^31: the worst case, 73728 * 127^2 = 1.19e9, comes out exact
    from the plain int32 path (the reference's int32 accumulator) and
    from its float32 reading, for codes all +127 and alternating in
    sign."""
    k = 73728
    assert k * 127 ** 2 < 2 ** 31
    xq = np.full((3, k), 127, np.int8)
    xq[1] = -127
    xq[2, 1::2] = -127
    wq = np.full((k, 2), 127, np.int8)
    wq[:, 1] = -127
    got = tref.int_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(exact).max() == k * 127 ** 2
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    sx = np.ones((3, 1), np.float32)
    sw = np.ones((1, 2), np.float32)
    np.testing.assert_array_equal(
        tref.quant_matmul_ref(*map(torch.from_numpy, (xq, sx, wq, sw)))
        .numpy(), np.asarray(jref.quant_matmul_ref(xq, sx, wq, sw)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,axis", [((24, 37), 0), ((3, 20, 9), 1)])
def test_quantize_in_column_blocks_matches_reference(monkeypatch, shape,
                                                     axis, dtype):
    """A tensor past BLOCK_ELEMENTS (the head's 18432 x 256,000 at full
    size, here a block of 100 elements) is quantized in `column_blocks`:
    the blocks cover every column once, none holds more than
    BLOCK_ELEMENTS elements, and codes and scales are the reference's
    bit for bit."""
    monkeypatch.setattr(tquant, "BLOCK_ELEMENTS", 100)
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    xt = _t(x)
    blocks = tquant.column_blocks(xt)
    assert len(blocks) > 1
    cols = [j for b in blocks for j in range(shape[-1])[b]]
    assert cols == list(range(shape[-1]))
    assert all(xt[..., b].numel() <= 100 for b in blocks)
    for wl in (4, 8):
        got = tquant.quantize(xt, wl, axis)
        want = jquant.quantize(jnp.asarray(x), wl, axis)
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
        assert _same_bits(got.scale, want.scale)


# --------------------------------------------------------------- engine --
def _requests(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in (5, 17, 9)]


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("plan", ["itera", "quant"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_matches_reference_engine(models, dtype, plan, kv_bits):
    """Greedy serve of the smoke model (3 ragged requests, 5 new tokens
    each) gives the reference engine's tokens, every one of them, at kv
    16 (a pool in the model's dtype) and kv 8 (int8 codes, fp32
    scales)."""
    jp, tp = models[dtype, plan]
    jc, tc = _cfgs(dtype, kv_cache_bits=kv_bits)
    reqs = _requests(jc.vocab_size)
    jr = jengine.InferenceEngine.build(jc, None, params=jp).serve(
        reqs, jengine.SamplingParams(max_tokens=5))
    tr = tengine.InferenceEngine.build(tc, None, params=tp,
                                       device="cpu").serve(
        [torch.tensor(r) for r in reqs], tengine.SamplingParams(max_tokens=5))
    for a, b in zip(jr.outputs, tr.outputs):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_serve_cli_matches_reference_cli(monkeypatch):
    """`launch.serve --arch nemotron-4-340b --smoke --ragged --compression
    quant --wl 4` serves the reference CLI's tokens when both start from
    the reference's seed-0 weights (the port's own `init_params` draws
    other numbers, so it is handed the reference's here)."""
    jc, _ = _cfgs()

    def reference_weights(cfg, *, seed=0, device="cpu"):
        params = jtfm.init_params(jax.random.PRNGKey(seed), jc)
        return bridge.from_flat(jck._flatten(params))

    argv = ["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len", "12",
            "--gen", "4", "--ragged", "--compression", "quant", "--wl", "4"]
    want = jserve.main(argv)
    monkeypatch.setattr(ttfm, "init_params", reference_weights)
    got = tserve.main(argv + ["--device", "cpu"])
    assert np.asarray(want).shape == (3, 4)
    np.testing.assert_array_equal(np.stack(got.outputs), np.asarray(want))

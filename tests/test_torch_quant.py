"""The port's quantization containers, ITERA decomposition, plans and
compression, held against the JAX reference on the same numpy inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as jplan
from repro.core import itera as jitera
from repro.core import quant as jquant
from repro.core.compress import compress_params as j_compress
from repro.models import transformer as jtfm
from repro_torch.api import plan as tplan
from repro_torch.core import itera as titera
from repro_torch.core import quant as tquant
from repro_torch.core.compress import compress_params as t_compress
from repro_torch.core.compress import flatten

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


def lowrankish(seed, k, n, decay=0.15):
    """A matrix with a decaying spectrum and sparse outliers, like trained
    LLM weights (the shape of `tests/test_itera.py::lowrankish`)."""
    rng = np.random.default_rng(seed)
    m = min(k, n)
    u = rng.standard_normal((k, m))
    v = rng.standard_normal((m, n))
    w = (u * np.exp(-decay * np.arange(m))) @ v
    w += (rng.random((k, n)) < 0.002) * 8.0
    return w.astype(np.float32)


def test_qmax_matches_reference():
    for wl in (2, 4, 6, 8):
        assert tquant.qmax(wl) == jquant.qmax(wl)
    with pytest.raises(ValueError):
        tquant.qmax(1)


@pytest.mark.parametrize("wl", [4, 6, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_matches_reference(wl, axis):
    x = np.random.default_rng(wl * 10 + axis).standard_normal(
        (48, 40)).astype(np.float32)
    x[3] = 0.0                      # an all-zero row: scale falls back to 1
    j = jquant.quantize(jnp.asarray(x), wl, axis=axis)
    t = tquant.quantize(torch.from_numpy(x), wl, axis=axis)
    np.testing.assert_array_equal(t.values.numpy(), _np(j.values))
    np.testing.assert_array_equal(t.scale.numpy(), _np(j.scale))
    assert (t.wl, t.axis, t.shape) == (j.wl, j.axis, tuple(j.shape))
    np.testing.assert_array_equal(t.dequant().numpy(), _np(j.dequant()))
    assert t.storage_bits() == j.storage_bits()


def test_pack_unpack_int4_byte_for_byte():
    codes = np.random.default_rng(0).integers(
        -8, 8, size=(3, 16, 32)).astype(np.int8)
    tp = tquant.pack_int4(torch.from_numpy(codes))
    jp = jquant.pack_int4(jnp.asarray(codes))
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    # element 2i is the LOW nibble of byte i
    assert (int(tp[0, 0, 0]) & 0x0F) == (int(codes[0, 0, 0]) & 0x0F)
    np.testing.assert_array_equal(tquant.unpack_int4(tp).numpy(), codes)
    np.testing.assert_array_equal(
        tquant.unpack_int4(torch.from_numpy(np.array(jp))).numpy(),
        _np(jquant.unpack_int4(jp)))
    with pytest.raises(ValueError):
        tquant.pack_int4(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize("dim", [63, 64, 129, 200, 256, 384])
def test_packing_rule_is_the_reference_rule(dim):
    assert tquant.packed_pad_ok(dim) == jquant.packed_pad_ok(dim)
    x = np.random.default_rng(dim).standard_normal(
        (16, dim)).astype(np.float32)
    for wl in (4, 6, 8):
        tq = tquant.pack_weights(tquant.quantize(torch.from_numpy(x), wl))
        jq = jquant.pack_weights(jquant.quantize(jnp.asarray(x), wl))
        assert tq.packed == jq.packed == tquant.packs(wl, dim)
        np.testing.assert_array_equal(tq.values.numpy(), _np(jq.values))
        assert tq.storage_bits() == jq.storage_bits()
        if tq.packed:
            np.testing.assert_array_equal(
                tquant.unpack_int4(tq.values).numpy(),
                _np(jquant.unpack_weights(jq).values))


@pytest.mark.parametrize("wl,seed", [(4, 0), (6, 1)])
def test_itera_error_matches_reference(wl, seed):
    """Codes differ (the warm starts come from different generators), so
    the port is held to the reference's reconstruction error: within 5%
    of ITERA's in JAX, and no worse than JAX's SVD-then-quantize
    baseline + 1e-4 (the paper's claim at the matrix level)."""
    w = lowrankish(seed, 96, 96)
    r = 32
    e_j = float(jitera.reconstruction_error(
        jnp.asarray(w), jitera.itera_decompose(jnp.asarray(w), r, wl)))
    e_svd = float(jitera.reconstruction_error(
        jnp.asarray(w), jitera.svd_decompose(jnp.asarray(w), r, wl)))
    lr = titera.itera_decompose(torch.from_numpy(w), r, wl)
    e_t = float(titera.reconstruction_error(torch.from_numpy(w), lr))
    assert e_t <= 1.05 * e_j, (e_t, e_j)
    assert e_t <= e_svd + 1e-4, (e_t, e_svd)
    assert lr.w1.values.dtype == torch.int8 and lr.rank == r
    assert tuple(lr.w1.scale.shape) == (1, r)
    assert tuple(lr.w2.scale.shape) == (r, 1)
    assert int(lr.w1.values.abs().max()) <= tquant.qmax(wl)


def test_itera_stacked_layers_equal_per_slice():
    """A scan-stacked (L, K, N) leaf decomposes as one batch: each slice
    equals decomposing that slice alone."""
    ws = np.stack([lowrankish(s, 40, 56) for s in range(3)])
    lr = titera.itera_decompose(torch.from_numpy(ws), 8, 4)
    for i in range(3):
        one = titera.itera_decompose(torch.from_numpy(ws[i]), 8, 4)
        torch.testing.assert_close(lr.w1.values[i], one.w1.values,
                                   rtol=0, atol=0)
        torch.testing.assert_close(lr.w2.values[i], one.w2.values,
                                   rtol=0, atol=0)
        torch.testing.assert_close(lr.w1.scale[i], one.w1.scale)
        torch.testing.assert_close(lr.w2.scale[i], one.w2.scale)


def test_truncate_is_a_shorter_decomposition_and_keeps_aux():
    w = torch.from_numpy(lowrankish(5, 48, 64))
    full = titera.itera_decompose(w, 16, 4)
    short = titera.itera_decompose(w, 6, 4)
    cut = titera.truncate(full, 6)
    for a, b in ((cut.w1, short.w1), (cut.w2, short.w2)):
        assert torch.equal(a.values, b.values)
        assert torch.equal(a.scale, b.scale)
    a4 = titera.LowRankQ(dataclasses.replace(full.w1, act_wl=4),
                         dataclasses.replace(full.w2, act_wl=4))
    assert titera.truncate(a4, 6).act_wl == 4
    packed = titera.LowRankQ(
        dataclasses.replace(full.w1, values=tquant.pack_int4(full.w1.values),
                            packed=True), full.w2)
    with pytest.raises(ValueError):
        titera.truncate(packed, 4)


def test_plan_json_round_trips_between_packages(tmp_path):
    lp = [jplan.LayerPlan("layers/attn/wq", "itera", 4, 16),
          jplan.LayerPlan("lm_head", "quant", 8)]
    jp = jplan.CompressionPlan(layers=tuple(lp), act_wl=6, pack=False,
                               label="mixed", meta={"src": "dse"})
    path = tmp_path / "plan.json"
    jp.save(str(path))
    tp = tplan.CompressionPlan.load(str(path))
    assert tp.to_dict() == jp.to_dict()
    back = jplan.CompressionPlan.loads(tp.dumps())
    assert back.to_dict() == jp.to_dict()
    with pytest.raises(ValueError, match="rank"):
        tplan.CompressionPlan(
            layers=(tplan.LayerPlan("a", "itera", 4, None),)).validate()
    with pytest.raises(ValueError, match="newer"):
        tplan.CompressionPlan.from_dict({"format_version": 99})


@pytest.fixture(scope="module")
def smoke_params():
    """The same random smoke-size weights for both packages."""
    from repro.configs import get_config

    import jax

    cfg = get_config("opus-mt", smoke=True)
    jp = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    tp = {}

    def put(path, leaf):
        node = tp
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = torch.from_numpy(np.array(leaf))

    from repro.core.compress import param_leaves_by_path

    for path, leaf in param_leaves_by_path(jp).items():
        put(path, leaf)
    return jp, tp


@pytest.mark.parametrize("method,wl", [("quant", 8), ("quant", 4),
                                       ("itera", 4)])
def test_uniform_plan_and_compression_match_reference(smoke_params, method,
                                                      wl):
    """The same plan (paths, ranks, word lengths) in both packages; for
    quantization, whose codes are deterministic, the same compressed
    tree. (ITERA's compression is held to the reference through the
    bridge in test_torch_engine.py.)"""
    jp, tp = smoke_params
    jpl = jplan.CompressionPlan.uniform(jp, method=method, weight_wl=wl)
    tpl = tplan.CompressionPlan.uniform(tp, method=method, weight_wl=wl)
    assert tpl.to_dict() == jpl.to_dict()
    if method != "quant":
        return
    jc, jrep = j_compress(jp, jpl)
    tc, trep = t_compress(tp, tpl)
    assert trep.compression_ratio == pytest.approx(jrep.compression_ratio)
    assert trep.nops_per_row == jrep.nops_per_row
    assert [(l.path, l.bits, l.packed) for l in trep.layers] == \
        [(l.path, l.bits, l.packed) for l in jrep.layers]
    from repro.core.compress import param_leaves_by_path

    jleaves = param_leaves_by_path(jc)
    for path, node in flatten(tc).items():
        if isinstance(node, tquant.QuantizedTensor):
            # quantize is deterministic: the codes are the reference's
            np.testing.assert_array_equal(
                node.values.numpy(), _np(jleaves[path + "/values"]))
            np.testing.assert_array_equal(
                node.scale.numpy(), _np(jleaves[path + "/scale"]))
            assert (node.wl, node.axis, node.act_wl) == (wl, 0, 8)

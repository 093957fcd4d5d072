"""The rest of the paper's compression flow in the port -- the SVD-then-
quantize baseline, Algorithm 1's exact-SVD engine, shaped spectra, the
uniform `CompressionConfig` shim and SRA's evaluation closure -- held
against the JAX reference on the same numpy inputs.

SVD parity cannot be bitwise: LAPACK under torch and under jax return each
singular vector with its own sign, and the vectors differ in the last
bits, more so where neighbouring singular values lie close. So codes are
compared after a sign flip per component, scales and reconstruction
errors relatively, each with the tolerance written beside it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as jplan
from repro.configs import get_config as j_get_config
from repro.core import compress as jcomp
from repro.core import itera as jitera
from repro.models import transformer as jtfm
from repro_torch.api import engine as tengine
from repro_torch.api import plan as tplan
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import compress as tcomp
from repro_torch.core import itera as titera
from repro_torch.core.compress import flatten
from repro_torch.launch import serve as tserve

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)


def lowrankish(seed, k, n, decay=0.15):
    """A decaying spectrum with sparse outliers, like trained LLM weights
    (the shape of `tests/test_itera.py::lowrankish`)."""
    rng = np.random.default_rng(seed)
    m = min(k, n)
    u = rng.standard_normal((k, m))
    v = rng.standard_normal((m, n))
    w = (u * np.exp(-decay * np.arange(m))) @ v
    w += (rng.random((k, n)) < 0.002) * 8.0
    return w.astype(np.float32)


def power_law(seed, k, n, alpha):
    """A random matrix whose singular values fall as i^-alpha."""
    w = np.random.default_rng(seed).standard_normal((k, n))
    u, _, vt = np.linalg.svd(w, full_matrices=False)
    t = np.arange(1, min(k, n) + 1, dtype=np.float64) ** -alpha
    return ((u * t) @ vt).astype(np.float32)


def _codes_mismatch(j, t):
    """Fraction of codes of the port's factors (t) that differ from the
    reference's (j) once each component's sign is matched to it."""
    j1, t1 = np.asarray(j.w1.values, np.int64), t.w1.values.numpy().astype(
        np.int64)
    j2, t2 = np.asarray(j.w2.values, np.int64), t.w2.values.numpy().astype(
        np.int64)
    sign = np.where((j1 * t1).sum(axis=-2, keepdims=True) < 0, -1, 1)
    t1 = t1 * sign
    t2 = t2 * np.swapaxes(sign, -1, -2)
    return ((t1 != j1).sum() + (t2 != j2).sum()) / (j1.size + j2.size)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


# (matrix, rank, wl, scale tolerance). The scales' deviation grows as the
# gap between neighbouring singular values shrinks; measured on the CPU:
# at most 4.6e-6 on the first four cases, 2.6e-5 in the tail of the steep
# alpha-2 power law (components 27-31 of 64).
SVD_CASES = {
    "decay_64x256_r16_w8": (lowrankish(0, 64, 256), 16, 8, 1e-5),
    "decay_128x64_r32_w4": (lowrankish(1, 128, 64), 32, 4, 1e-5),
    "decay0.3_64x256_r16_w4": (lowrankish(0, 64, 256, 0.3), 16, 4, 1e-5),
    "alpha1_64x256_r32_w8": (power_law(0, 64, 256, 1.0), 32, 8, 1e-5),
    "alpha2_64x256_r32_w8": (power_law(0, 64, 256, 2.0), 32, 8, 5e-5),
}


@pytest.mark.parametrize("case", sorted(SVD_CASES))
def test_svd_decompose_matches_reference(case):
    w, r, wl, scale_tol = SVD_CASES[case]
    j = jitera.svd_decompose(jnp.asarray(w), r, wl)
    t = titera.svd_decompose(torch.from_numpy(w), r, wl)
    assert t.w1.values.dtype == torch.int8 and t.rank == r
    assert tuple(t.w1.scale.shape) == (1, r)
    assert tuple(t.w2.scale.shape) == (r, 1)
    assert (t.w1.wl, t.w1.axis, t.w2.axis) == (wl, 0, 1)
    # measured: at most 0.09% of codes (a last-bit flip of a rounding)
    assert _codes_mismatch(j, t) <= 0.01
    assert _rel(t.w1.scale.numpy(), j.w1.scale) <= scale_tol
    assert _rel(t.w2.scale.numpy(), j.w2.scale) <= scale_tol
    e_j = float(jitera.reconstruction_error(jnp.asarray(w), j))
    e_t = float(titera.reconstruction_error(torch.from_numpy(w), t))
    # measured: at most 2.7e-6 relative here (5.9e-5 at rank 48 of the
    # first case's matrix)
    assert abs(e_t - e_j) <= 1e-4 * e_j


def test_svd_decompose_stacked_equals_per_slice():
    """A scan-stacked (L, K, N) leaf decomposes as one batch, each slice
    as it would alone (the reference vmaps)."""
    ws = np.stack([lowrankish(s, 40, 56) for s in range(3)])
    lr = titera.svd_decompose(torch.from_numpy(ws), 8, 4)
    assert tuple(lr.w1.scale.shape) == (3, 1, 8)
    assert tuple(lr.w2.scale.shape) == (3, 8, 1)
    for i in range(3):
        one = titera.svd_decompose(torch.from_numpy(ws[i]), 8, 4)
        e_b = float(titera.reconstruction_error(
            torch.from_numpy(ws[i]), titera.LowRankQ(
                dataclasses.replace(lr.w1, values=lr.w1.values[i],
                                    scale=lr.w1.scale[i]),
                dataclasses.replace(lr.w2, values=lr.w2.values[i],
                                    scale=lr.w2.scale[i]))))
        e_1 = float(titera.reconstruction_error(torch.from_numpy(ws[i]),
                                                one))
        assert abs(e_b - e_1) <= 1e-5 * e_1


@pytest.mark.parametrize("wl", [4, 8])
def test_itera_svd_engine_matches_reference(wl):
    """Algorithm 1 with the exact-SVD rank-1 engine: each step's top
    triple differs from jax's only by its sign and last bits, and the
    quantized update is odd in it, so the decompositions agree."""
    w = lowrankish(2, 48, 64)
    j = jitera.itera_decompose(jnp.asarray(w), 12, wl, method="svd")
    t = titera.itera_decompose(torch.from_numpy(w), 12, wl, method="svd")
    # measured: no code differs after the sign match
    assert _codes_mismatch(j, t) <= 0.01
    e_j = float(jitera.reconstruction_error(jnp.asarray(w), j))
    e_t = float(titera.reconstruction_error(torch.from_numpy(w), t))
    # measured: at most 3.5e-7 relative
    assert abs(e_t - e_j) <= 1e-4 * e_j
    # the paper's property (tests/test_itera.py): no worse than SVD then
    # quantization at the same rank and word length
    e_svd = float(titera.reconstruction_error(
        torch.from_numpy(w), titera.svd_decompose(torch.from_numpy(w), 12,
                                                  wl)))
    assert e_t <= e_svd + 1e-4
    with pytest.raises(ValueError, match="rank-1 engine"):
        titera.itera_decompose(torch.from_numpy(w), 2, wl, method="qr")


@pytest.mark.parametrize("m", [1, 8, 2048])
def test_nops_matches_reference(m):
    w = lowrankish(3, 40, 56)
    j = jitera.svd_decompose(jnp.asarray(w), 8, 8)
    t = titera.svd_decompose(torch.from_numpy(w), 8, 8)
    assert t.nops(m) == j.nops(m) == m * 8 * (40 + 56)


def _to_port_tree(jp):
    """The reference's parameter tree as the port's (same paths)."""
    tp = {}
    for path, leaf in jcomp.param_leaves_by_path(jp).items():
        node = tp
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = torch.from_numpy(np.array(leaf))
    return tp


@pytest.fixture(scope="module")
def smoke():
    """Smoke-size opus-mt: the reference's random weights and the same
    tensors in the port's tree."""
    cfg = j_get_config("opus-mt", smoke=True)
    jp = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, _to_port_tree(jp)


@pytest.mark.parametrize("alpha", [0.0, 1.0, 2.0])
def test_shape_spectra_is_bit_equal(smoke, alpha):
    _, jp, tp = smoke
    js = jcomp.param_leaves_by_path(jcomp.shape_spectra(jp, alpha))
    ts = tcomp.shape_spectra(tp, alpha)
    moved = 0
    for path, leaf in flatten(ts).items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(js[path]),
                                      path)
        assert leaf.dtype == torch.float32
        moved += not torch.equal(leaf, flatten(tp)[path])
    assert moved == 7          # the six stacked linears and the lm head
    sel = tcomp.CompressionConfig(include=r"mlp")
    only = flatten(tcomp.shape_spectra(tp, alpha, selector=sel))
    for path, leaf in only.items():
        want = flatten(ts if "mlp" in path else tp)[path]
        assert torch.equal(leaf, want), path
    with pytest.raises(ValueError, match="alpha"):
        tcomp.shape_spectra(tp, -1.0)


def _report_fields(rep):
    return {l.path: (l.shape, l.method, l.rank, l.bits, l.fp32_bits,
                     l.nops_per_row, l.dense_nops_per_row, l.wl, l.packed)
            for l in rep.layers}


SPECS = {
    "plan_svd_w8_r0.75": lambda mod, p: mod.CompressionPlan.uniform(
        p, method="svd", weight_wl=8, rank_fraction=0.75),
    "plan_svd_w4_r0.5": lambda mod, p: mod.CompressionPlan.uniform(
        p, method="svd", weight_wl=4, rank_fraction=0.5),
    "config_svd_w8": "svd",
    "config_itera_w4": "itera",
    "config_quant_w4": "quant",
    "config_none": "none",
}


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_compress_params_report_matches_reference(smoke, spec):
    """An svd plan, and each method as a uniform `CompressionConfig`, give
    the reference's plan and report fields: resident bits, NOps, ratio,
    packing, ranks."""
    _, jp, tp = smoke
    make = SPECS[spec]
    if callable(make):
        js, ts = make(jplan, jp), make(tplan, tp)
    else:
        wl = 8 if make == "svd" else 4
        js = jcomp.CompressionConfig(method=make, weight_wl=wl,
                                     power_iters=4)
        ts = tcomp.CompressionConfig(method=make, weight_wl=wl,
                                     power_iters=4)
    jc, jrep = jcomp.compress_params(jp, js)
    tc, trep = tcomp.compress_params(tp, ts)
    assert trep.plan.to_dict() == jrep.plan.to_dict()
    assert _report_fields(trep) == _report_fields(jrep)
    assert (trep.skipped_params, trep.skipped_bits) == (jrep.skipped_params,
                                                        jrep.skipped_bits)
    assert trep.compression_ratio == pytest.approx(jrep.compression_ratio,
                                                   rel=1e-12)
    assert trep.nops_per_row == jrep.nops_per_row
    assert trep.dense_nops_per_row == jrep.dense_nops_per_row
    assert trep.summary().split(" (")[0] == jrep.summary().split(" (")[0]
    if spec == "config_none":
        assert tc is tp and trep.plan.label == "none"


def test_rank_alignment_of_sra_overrides_matches_reference():
    """`rank_for` aligns an SRA override to `rank_multiple` on matrices of
    at least 4 x 64 and clamps it to [min_rank, min(K, N)], as the
    reference does; the plan lowered from such a config is the
    reference's."""
    shapes = {"a": (256, 512), "b": (512, 300), "c": (2, 96, 128),
              "d": (300, 1000)}
    ranks = {"a": 100, "b": 63, "c": 7, "d": 1000}
    jp = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    tp = {k: torch.zeros(s) for k, s in shapes.items()}
    for method in ("svd", "itera"):
        jc = jcomp.CompressionConfig(method=method, ranks=ranks)
        tc = tcomp.CompressionConfig(method=method, ranks=ranks)
        for p, s in shapes.items():
            assert tc.rank_for(p, s[-2:]) == jc.rank_for(p, s[-2:]), p
        assert tc.to_plan(tp).to_dict() == jc.to_plan(jp).to_dict()
    assert [lp.rank for lp in tc.to_plan(tp).layers] == [64, 64, 7, 300]


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def shaped(smoke):
    _, jp, _ = smoke
    js = jcomp.shape_spectra(jp, 2.0)
    return js, _to_port_tree(js)


def test_sra_eval_closure_matches_reference(shaped):
    """Both closures list the same layers and ranks, and evaluate three
    allocations alike under one quality function (the mean relative
    reconstruction error of the compressed linears, negated)."""
    js, ts = shaped
    jcfg = jcomp.CompressionConfig(method="svd", weight_wl=8)
    tcfg = tcomp.CompressionConfig(method="svd", weight_wl=8)

    def quality(paths, orig, err):
        def q(cp):
            return -float(np.mean([err(_leaf(orig, p), _leaf(cp, p))
                                   for p in paths]))
        return q

    jpaths = [p for p, _ in jcomp.eligible_linears(js, jcfg)]
    j_eval, j_paths, j_max = jcomp.sra_eval_closure(
        js, jcfg, quality(jpaths, js, jitera.reconstruction_error))
    t_eval, t_paths, t_max = tcomp.sra_eval_closure(
        ts, tcfg, quality(jpaths, ts, titera.reconstruction_error))
    assert t_paths == j_paths == jpaths
    assert t_max == j_max == [64] * 7
    for alloc in ([32] * 7, [8, 64, 16, 40, 48, 24, 24],
                  [48, 16, 32, 32, 32, 32, 32]):
        qj, qt = j_eval(alloc), t_eval(alloc)
        # measured: at most 2.5e-6 relative
        assert qt == pytest.approx(qj, rel=1e-4), alloc


def test_reference_svd_plan_builds_and_serves_in_the_port(smoke):
    """A plan the reference wrote with `svd` layers loads, builds (the
    port compresses it) and serves; an SRA-style `CompressionConfig` with
    per-layer ranks builds through the same entry point."""
    cfg, jp, tp = smoke
    text = jplan.CompressionPlan.uniform(jp, method="svd", weight_wl=8,
                                         rank_fraction=0.75).dumps()
    plan = tplan.CompressionPlan.loads(text)
    tcfg = t_get_config("opus-mt", smoke=True)
    eng = tengine.InferenceEngine.build(tcfg, plan, params=tp, device="cpu",
                                        max_batch=2)
    assert eng.plan.to_dict() == plan.to_dict()
    assert {l.method for l in eng.report.layers} == {"svd"}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 5, 12)]
    res = eng.serve(prompts, tengine.SamplingParams(max_tokens=3))
    assert [o.size for o in res.outputs] == [3, 3, 3]
    ranks = {"layers/mlp/up": 16, "lm_head": 40}
    sra = tengine.InferenceEngine.build(
        tcfg, tcomp.CompressionConfig(method="svd", weight_wl=8,
                                      ranks=ranks), params=tp, device="cpu")
    got = {lp.path: lp.rank for lp in sra.plan.layers}
    assert got["layers/mlp/up"] == 16 and got["lm_head"] == 40
    assert sra.plan.to_dict() == jplan.CompressionPlan.from_config(
        jp, jcomp.CompressionConfig(method="svd", weight_wl=8,
                                    ranks=ranks)).to_dict()
    none = tengine.InferenceEngine.build(
        tcfg, tcomp.CompressionConfig(method="none"), params=tp,
        device="cpu")
    assert none.plan is None


def test_cli_serves_a_uniform_svd_config(capsys):
    res = tserve.main(["--arch", "opus-mt", "--smoke", "--device", "cpu",
                       "--compression", "svd", "--wl", "8",
                       "--rank-fraction", "0.75", "--batch", "2",
                       "--prompt-len", "10", "--gen", "2", "--ragged"])
    assert [o.size for o in res.outputs] == [2, 2]
    out = capsys.readouterr().out
    assert "svd_W8x7" in out

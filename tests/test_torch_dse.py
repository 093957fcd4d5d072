"""The port's design space exploration (`repro_torch.hw.dse`) and the plan
hooks that carry a design point into deployment (`by_path`,
`from_design_point`, `merge_plans`, `core.compress.param_leaves_by_path`)
against the JAX reference on the same weights, plans and quality values;
then the paper's §VII loop end to end on the CPU: co_design on the H100
model -> from_design_point -> JSON -> InferenceEngine.build -> tokens,
the reference engine's for the same plan and weights, and the serve CLI
on the same JSON."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import engine as jengine
from repro.api import plan as jplan
from repro.configs import get_config as j_get_config
from repro.core import compress as jcomp
from repro.hw import dse as jdse
from repro.models import transformer as jtfm
from repro_torch.api import engine as tengine
from repro_torch.api import plan as tplan
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import compress as tcomp
from repro_torch.hw import dse as tdse
from repro_torch.hw import h100_model as hm
from repro_torch.launch import serve as tserve

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)


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
    cfg = j_get_config("opus-mt", smoke=True)
    jp = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, _to_port_tree(jp)


def _candidates(mod, params):
    """The same candidates in either package: quant W8 and W4, ITERA W4 at
    rank fraction 0.5, and a mixed plan (W4 attention at half that rank,
    W8 MLP)."""
    base = mod.CompressionPlan.uniform(params, method="itera", weight_wl=4,
                                       rank_fraction=0.5, label="itera_W4")
    mixed = base.replace(label="mixed_w4_w8", layers=tuple(
        mod.LayerPlan(lp.path, "itera", 4 if "attn" in lp.path else 8,
                      max(1, lp.rank // 2) if "attn" in lp.path else lp.rank)
        for lp in base.layers))
    return [mod.CompressionPlan.uniform(params, method="quant", weight_wl=8),
            mod.CompressionPlan.uniform(params, method="quant", weight_wl=4),
            base, mixed]


# quality values given to both packages' co_design
QUALITY = {"quant_W8": 0.99, "quant_W4": 0.9, "itera_W4": 0.93,
           "mixed_w4_w8": 0.95}


def test_param_leaves_by_path_is_the_reference(smoke):
    _, jp, tp = smoke
    want = jcomp.param_leaves_by_path(jp)
    got = tcomp.param_leaves_by_path(tp)
    assert list(got) == list(want) or sorted(got) == sorted(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[path]))


def test_layer_shapes_are_the_reference(smoke):
    """layer_shapes_from_plan over each candidate, and
    model_layers_from_report over its compression report, give the
    reference's LayerShape lists."""
    _, jp, tp = smoke
    for jc, tc in zip(_candidates(jplan, jp), _candidates(tplan, tp)):
        want = [dataclasses.asdict(l) for l in
                jdse.layer_shapes_from_plan(jc, jp)]
        got = [dataclasses.asdict(l) for l in
               tdse.layer_shapes_from_plan(tc, tp)]
        assert got == want, tc.label
    for spec in ("quant", "svd"):
        _, jrep = jcomp.compress_params(
            jp, jcomp.CompressionConfig(method=spec, weight_wl=8))
        _, trep = tcomp.compress_params(
            tp, tcomp.CompressionConfig(method=spec, weight_wl=8))
        assert [dataclasses.asdict(l) for l in
                tdse.model_layers_from_report(trep)] == \
            [dataclasses.asdict(l) for l in
             jdse.model_layers_from_report(jrep)]


@pytest.mark.parametrize("batch_m", [8, 64])
def test_zcu111_co_design_is_the_reference(smoke, batch_m):
    """The same candidates and quality values give the reference's front:
    labels, latencies in cycles and per-layer engine choices; `pareto`
    alike over the points."""
    _, jp, tp = smoke
    jc, tc = _candidates(jplan, jp), _candidates(tplan, tp)
    want = jdse.co_design(jc, lambda p: QUALITY[p.label], params=jp,
                          batch_m=batch_m, platform="zcu111")
    got = tdse.co_design(tc, lambda p: QUALITY[p.label], params=tp,
                         batch_m=batch_m, platform="zcu111")
    assert [p.label for p in got] == [p.label for p in want]
    for g, w in zip(got, want):
        assert (g.quality, g.latency, g.per_layer) == \
            (w.quality, w.latency, w.per_layer)
        assert g.plan.to_dict() == w.plan.to_dict()
    pts = [tdse.DesignPoint(l, q, lat, 0.0, 0.0, [])
           for l, q, lat in (("a", 0.5, 3.0), ("b", 0.9, 5.0),
                             ("c", 0.4, 4.0), ("d", 0.9, 2.0),
                             ("e", 0.95, 9.0))]
    jpts = [jdse.DesignPoint(**dataclasses.asdict(p)) for p in pts]
    assert [p.label for p in tdse.pareto(pts)] == \
        [p.label for p in jdse.pareto(jpts)] == ["d", "e"]


def test_co_design_platforms_and_candidates(smoke):
    _, _, tp = smoke
    cands = _candidates(tplan, tp)
    with pytest.raises(ValueError, match="platform"):
        tdse.co_design(cands, lambda p: 0.0, params=tp, platform="tpu")
    with pytest.raises(TypeError, match="CompressionPlan"):
        tdse.co_design([{"label": "quant_W4"}], lambda p: 0.0, params=tp)
    with pytest.raises(ValueError, match="layers_fn or params"):
        tdse.co_design(cands, lambda p: 0.0)


def test_h100_co_design_prices_the_engines_allowed(smoke):
    """On the H100 model a plan's meta restricts its low-rank layers'
    engines; a dense layer (the quant lm head of a low-rank plan) runs
    on `baseline`; the front's points carry their plans, ratio and NOps
    from meta, and their latency is the sum of the priced layers."""
    _, _, tp = smoke
    itera = tplan.merge_plans(_candidates(tplan, tp)[2], [
        tplan.LayerPlan("lm_head", "quant", 8)]).replace(
        label="itera+head",
        meta={"engines_allowed": ["cascade"], "ratio": 3.5, "nops": 7.0})
    quant = _candidates(tplan, tp)[1].replace(
        meta={"engines_allowed": ["baseline"]})
    for batch_m in (8, 512):
        front = tdse.co_design([itera, quant],
                               lambda p: 1.0 if p is itera else 0.5,
                               params=tp, batch_m=batch_m)
        by_label = {p.label: p for p in front}
        assert "itera+head" in by_label
        dp = by_label["itera+head"]
        kinds = [(name, kind) for name, kind, _, _ in dp.per_layer]
        assert ("lm_head", "baseline") in kinds
        assert {k for name, k in kinds if name != "lm_head"} == {"cascade"}
        assert (dp.compression_ratio, dp.nops) == (3.5, 7.0)
        assert dp.latency == pytest.approx(sum(c[2] for c in dp.per_layer))
        shapes = tdse.layer_shapes_from_plan(itera, tp)
        want, _ = tdse.total_latency_h100(shapes, batch_m,
                                          engines=("cascade",))
        assert dp.latency == want
        free, chosen = tdse.total_latency_h100(shapes, batch_m)
        assert free <= want and len(chosen) == len(shapes)


def test_plan_hooks_give_the_reference_json(smoke, tmp_path):
    """by_path, __iter__/__len__, merge_plans and from_design_point give
    the reference's plans and JSON, and a plan written by either package's
    from_design_point loads in the other."""
    _, jp, tp = smoke
    jc, tc = _candidates(jplan, jp)[2], _candidates(tplan, tp)[2]
    assert list(tc) == list(tc.layers) and len(tc) == len(jc)
    assert {k: v.to_dict() for k, v in tc.by_path().items()} == \
        {k: v.to_dict() for k, v in jc.by_path().items()}
    over_t = [tplan.LayerPlan("layers/attn/wq", "quant", 6),
              tplan.LayerPlan("extra", "quant", 8)]
    over_j = [jplan.LayerPlan(**dataclasses.asdict(lp)) for lp in over_t]
    mt, mj = tplan.merge_plans(tc, over_t), jplan.merge_plans(jc, over_j)
    assert mt.dumps() == mj.dumps()
    assert mt.by_path()["layers/attn/wq"].wl == 6 and len(mt) == len(tc) + 1
    per_layer = [(lp.path, "cascade", 1e-5, {}) for lp in tc.layers]
    tdp = tdse.DesignPoint("dp", 0.93, 2.5e-4, 3.0, 1e6, per_layer,
                           plan=mt.replace(meta={"ratio": 3.0}))
    jdp = jdse.DesignPoint("dp", 0.93, 2.5e-4, 3.0, 1e6, per_layer,
                           plan=mj.replace(meta={"ratio": 3.0}))
    tdep = tplan.CompressionPlan.from_design_point(tdp)
    jdep = jplan.CompressionPlan.from_design_point(jdp)
    assert tdep.dumps() == jdep.dumps()
    assert tdep.meta["engines"][0] == ["layers/attn/wk", "cascade"]
    tdep.save(str(tmp_path / "t.json"))
    jdep.save(str(tmp_path / "j.json"))
    assert jplan.CompressionPlan.load(str(tmp_path / "t.json")).to_dict() \
        == jdep.to_dict()
    assert tplan.CompressionPlan.load(str(tmp_path / "j.json")).to_dict() \
        == tdep.to_dict()
    with pytest.raises(ValueError, match="no plan"):
        tplan.CompressionPlan.from_design_point(
            dataclasses.replace(tdp, plan=None))


def test_design_point_to_engine_end_to_end(smoke, tmp_path, capsys):
    """tests/test_api.py::test_design_point_to_engine_end_to_end on the
    port: co_design over plan candidates on the H100 model -> the front's
    highest-quality point -> from_design_point -> JSON -> build on the CPU
    -> greedy tokens, equal to the reference engine's for the same plan
    and weights; the serve CLI serves the same JSON."""
    cfg, jp, tp = smoke
    tcfg = t_get_config("opus-mt", smoke=True)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    h_ref = jtfm.forward(jp, toks, cfg)[0]

    def quality(plan):
        """The reference's relative hidden-state error, negated."""
        cp, rep = jcomp.compress_params(
            jp, jplan.CompressionPlan.loads(plan.dumps()))
        plan.meta["ratio"] = rep.compression_ratio
        h = jtfm.forward(cp, toks, cfg)[0]
        return -float(np.linalg.norm(np.asarray(h - h_ref))
                      / np.linalg.norm(np.asarray(h_ref)))

    front = tdse.co_design(_candidates(tplan, tp), quality, params=tp,
                           batch_m=64)
    assert front and all(dp.plan is not None for dp in front)
    assert all(isinstance(c[3]["tiles"], (dict, list))
               for dp in front for c in dp.per_layer)
    dp = front[-1]                              # highest-quality point
    plan = tplan.CompressionPlan.from_design_point(dp)
    assert plan.meta["design_point"] == dp.label
    assert plan.meta["latency"] == pytest.approx(dp.latency)
    path = tmp_path / "plan.json"
    plan.save(str(path))
    restored = tplan.CompressionPlan.load(str(path))
    assert restored.to_dict() == plan.to_dict()

    engine = tengine.InferenceEngine.build(tcfg, restored, params=tp,
                                           device="cpu")
    res = engine.generate(toks[:, :12].astype(np.int32),
                          tengine.SamplingParams(max_tokens=4))
    assert res.tokens.shape == (2, 4)
    assert engine.report is not None and engine.report.plan is not None
    jeng = jengine.InferenceEngine.build(
        cfg, jplan.CompressionPlan.load(str(path)), params=jp)
    want = jeng.generate(toks[:, :12].astype(np.int32),
                         jengine.SamplingParams(max_tokens=4))
    np.testing.assert_array_equal(res.tokens, np.asarray(want.tokens))

    out = tserve.main(["--arch", "opus-mt", "--smoke", "--plan", str(path),
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "12", "--gen", "3"])
    assert np.asarray(out.tokens).shape == (2, 3)
    assert dp.label in capsys.readouterr().out


def test_h100_front_orders_by_the_model(smoke):
    """The H100 front is sorted by predicted latency with rising quality;
    every point's latency is its layers' priced launches, each layer
    priced as best_point prices it."""
    _, _, tp = smoke
    cands = _candidates(tplan, tp)
    front = tdse.co_design(cands, lambda p: QUALITY[p.label], params=tp,
                           batch_m=8)
    lats = [p.latency for p in front]
    quals = [p.quality for p in front]
    assert lats == sorted(lats) and quals == sorted(quals)
    for dp in front:
        for (name, kind, lat, _), shape in zip(
                dp.per_layer, tdse.layer_shapes_from_plan(dp.plan, tp)):
            p = hm.best_point(8, shape.k, shape.n, shape.rank,
                              weight_wl=shape.wl)
            assert (kind, lat) == (p.kind, p.latency_s), name

"""The port's self-speculative decoding (`repro_torch.runtime.speculation`,
the scheduler's draft reservations, `verify_width` and the engine's
speculative loop) held to the JAX reference on the same inputs, on the
CPU.

Tolerances: none. Draft weights are integer codes and float32 scales
copied or sliced, so they must be equal; tokens, accept counts and block
bookkeeping must be equal. Speculative stops are held to
`match_stop_host` over the run without stops.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import bridged  # noqa: F401 (the shared fixture)

from repro.api import engine as jengine
from repro.api import plan as jplan
from repro.models import transformer as jtfm
from repro.runtime import kvblocks as jkv
from repro.runtime import scheduler as jsched
from repro.runtime import speculation as jspec
from repro_torch.api import engine as tengine
from repro_torch.api import plan as tplan
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.compress import flatten
from repro_torch.core.itera import LowRankQ
from repro_torch.launch import serve as tserve
from repro_torch.runtime import kvblocks as tkv
from repro_torch.runtime import sampling as tsmp
from repro_torch.runtime import scheduler as tsched
from repro_torch.runtime import speculation as tspec

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

SPEC = dict(k=3, rank_fraction=0.5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _nodes(tree, flat):
    """{path/field: np.ndarray} over a parameter tree's arrays, with each
    quantized node's format."""
    out = {}
    for path, leaf in flat(tree).items():
        if isinstance(leaf, (LowRankQ, jspec.LowRankQ)):
            parts = {"w1": leaf.w1, "w2": leaf.w2}
        else:
            parts = {"": leaf}
        for name, q in parts.items():
            p = f"{path}/{name}" if name else path
            if hasattr(q, "wl"):
                out[p + ":values"] = np.asarray(q.values)
                out[p + ":scale"] = np.asarray(q.scale)
                out[p + ":fmt"] = (q.wl, q.packed, q.act_wl)
            else:
                out[p] = np.asarray(q)
    return out


# --------------------------------------------------------- draft tree --

@pytest.mark.parametrize("spec", [dict(k=3, rank_fraction=0.5),
                                  dict(k=2, rank_fraction=0.75, act_wl=6)])
def test_derive_draft_params_equal_reference(bridged, spec):  # noqa: F811
    """The truncated (and repacked, and restamped) cascade equals the
    reference's array for array; dense tensors are shared, not copied."""
    _, jparams, tparams, _ = bridged
    jd = jspec.derive_draft_params(jparams, jspec.DraftSpec(**spec))
    td = tspec.derive_draft_params(tparams, tspec.DraftSpec(**spec))
    want = _nodes(jd, flatten)
    got = _nodes(td, flatten)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.endswith(":fmt"):
            assert got[k] == v, k
        else:
            np.testing.assert_array_equal(got[k], v, k)
            assert got[k].dtype == v.dtype, k
    flat_p, flat_d = flatten(tparams), flatten(td)
    truncated = 0
    for path, leaf in flat_p.items():
        d = flat_d[path]
        if isinstance(leaf, torch.Tensor):
            assert d is leaf, path
        if isinstance(leaf, LowRankQ):
            truncated += d.w2.shape[-2] < leaf.w2.shape[-2]
            assert d.w1.values.is_contiguous()
    assert truncated > 0
    assert not tspec.is_exact_draft(tparams, td)
    full = tspec.derive_draft_params(tparams, tspec.DraftSpec(
        rank_fraction=1.0))
    assert tspec.is_exact_draft(tparams, full)


def test_draft_rank_and_spec_equal_reference():
    for r in (1, 7, 32, 100, 128, 192, 256, 320, 512, 1024):
        for f in (0.1, 0.25, 0.5, 0.6, 0.7, 0.75, 1.0):
            assert tspec.draft_rank(r, f) == jspec.draft_rank(r, f), (r, f)
    for bad in (dict(k=0), dict(rank_fraction=0.0), dict(rank_fraction=1.2),
                dict(act_wl=1), dict(act_wl=9)):
        with pytest.raises(ValueError):
            tspec.DraftSpec(**bad)
        with pytest.raises(ValueError):
            jspec.DraftSpec(**bad)
    spec = tspec.DraftSpec(k=3, rank_fraction=0.7, act_wl=6)
    assert spec.to_dict() == jspec.DraftSpec(**spec.to_dict()).to_dict()
    assert tspec.DraftSpec.from_dict(spec.to_dict()) == spec


def test_plan_carries_draft_through_json():
    """A plan's draft survives the JSON round trip in both directions
    between the packages, and the port's summary names it."""
    t = tplan.CompressionPlan(label="p", draft=tspec.DraftSpec(
        k=3, rank_fraction=0.7))
    j = jplan.CompressionPlan.loads(t.dumps())
    assert j.draft == jspec.DraftSpec(k=3, rank_fraction=0.7)
    back = tplan.CompressionPlan.loads(j.dumps())
    assert back.draft == t.draft and back == t
    assert "draft k=3" in t.summary()
    assert tplan.CompressionPlan.loads(
        tplan.CompressionPlan().dumps()).draft is None


# --------------------------------------------------------- the step --

@pytest.mark.parametrize("sample", [False, True])
def test_speculative_step_equal_reference(bridged, sample):  # noqa: F811
    """k 3 over a mixed batch: a prefill row finishing its prompt, a
    decode row drafting 3, a decode row drafting 1 (with `sample`: a
    sampled row, which drafts nothing) and an idle row; two rounds, the
    second fed the first's next_prev. full_toks, n_acc and next_prev
    equal the reference's."""
    cfg, jparams, tparams, _ = bridged
    tcfg = t_get_config("opus-mt", smoke=True)
    spec_t = tspec.DraftSpec(**SPEC)
    jd = jspec.derive_draft_params(jparams, jspec.DraftSpec(**SPEC))
    td = tspec.derive_draft_params(tparams, spec_t)
    m, k = tsmp.SAMP_COLS, 3
    rng = np.random.default_rng(2)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12],
                      [0, 0, 0, 0]], np.int32)
    # first fill rows 1 and 2 with a prompt each (plain prefill, k 0)
    buf = np.zeros((4, 8 + 4 + m), np.int32)
    buf[:, :8] = rng.integers(1, cfg.vocab_size, (4, 8))
    buf[:, -(m + 3)] = [0, 6, 5, 0]
    req = tsched.Request(tokens=[1], max_tokens=9, rid=0, temperature=0.0,
                         top_k=0, top_p=1.0, seed=1)
    for r in range(3):
        tsmp.write_row_meta(buf, r, req, 0)
    pools = (jkv.init_paged_cache(cfg, 13, 4),
             tkv.init_paged_cache(tcfg, 13, 4, "cpu"))
    jprev, tprev = jnp.zeros((4, 1), jnp.int32), torch.zeros(
        (4, 1), dtype=torch.int32)
    steps = [(0, buf.copy())]
    # then row 0 prefills 7 tokens, rows 1 and 2 decode with 3 and 1
    # drafts, row 3 idles
    b2 = np.zeros_like(buf)
    b2[0, :7] = rng.integers(1, cfg.vocab_size, 7)
    b2[:, -(m + 4)] = [0, 6, 5, 0]
    b2[:, -(m + 3)] = [7, 4, 1 if sample else 2, 0]
    b2[:, -(m + 2)] = [0, 1, 1, 0]
    b2[:, -(m + 1)] = [0, 3, 0 if sample else 1, 0]
    hot = dataclasses.replace(req, temperature=0.9, top_k=20, top_p=0.9)
    for r in range(3):
        tsmp.write_row_meta(b2, r, hot if sample and r == 2 else req, 1)
    steps.append((k, b2))
    jpool, tpool = pools
    for i, (kk, sb) in enumerate(steps):
        jf, jn, jprev, jpool = jspec.speculative_step(
            jparams, jd, jpool, jnp.asarray(table), jnp.asarray(sb), jprev,
            cfg, kk, sample=sample)
        tf, tn, tprev, tpool = tspec.speculative_step(
            tparams, td, tpool, _t(table), _t(sb), tprev, tcfg, kk,
            sample=sample)
        live = [0, 1, 2] if i else [1, 2]
        np.testing.assert_array_equal(tf.numpy()[live],
                                      np.asarray(jf)[live], f"round {i}")
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(tprev.numpy()[live],
                                      np.asarray(jprev)[live])
        assert tf.shape == (4, kk + 2)


# ------------------------------------------------------------- serve --

def _prompts(vocab, seed=0, lens=(5, 11, 3, 14, 8)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def engines(bridged):  # noqa: F811
    """(reference engine, port engine) with a DraftSpec(**SPEC) draft per
    kv_bits, built once a module so the reference's jitted steps compile
    once."""
    cfg, jparams, tparams, _ = bridged
    made = {}

    def get(kv_bits=16):
        if kv_bits not in made:
            made[kv_bits] = (
                jengine.InferenceEngine(
                    dataclasses.replace(cfg, kv_cache_bits=kv_bits), jparams,
                    max_batch=3, block_size=4, chunk_tokens=8,
                    speculate=jspec.DraftSpec(**SPEC)),
                tengine.InferenceEngine.build(
                    t_get_config("opus-mt", smoke=True), None,
                    params=tparams, device="cpu", kv_bits=kv_bits,
                    max_batch=3, block_size=4, chunk_tokens=8,
                    speculate=tspec.DraftSpec(**SPEC)))
        return made[kv_bits]

    return get


def _same_tokens(a, b):
    assert len(a.outputs) == len(b.outputs)
    for i, (x, y) in enumerate(zip(a.outputs, b.outputs)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_speculative_serve_equal_plain_and_reference(engines, kv_bits):
    """Greedy speculative serve: the plain serve's tokens, and the
    reference's speculative serve's tokens, steps and accept counts."""
    je, te = engines(kv_bits)
    prompts = _prompts(te.cfg.vocab_size, seed=1)
    sp = dict(max_tokens=8)
    on = te.serve(prompts, tengine.SamplingParams(**sp))
    off = te.serve(prompts, tengine.SamplingParams(**sp), speculate=False)
    _same_tokens(on, off)
    assert off.spec_k == 0 and off.drafted == 0
    assert on.spec_k == 3 and on.drafted > 0 and on.spec_rounds > 0
    assert on.accept_rate == on.accepted / on.drafted
    ref = je.serve(prompts, jengine.SamplingParams(**sp))
    _same_tokens(on, ref)
    for f in ("steps", "drafted", "accepted", "spec_rounds",
              "prefill_chunks", "mixed_steps"):
        assert getattr(on, f) == getattr(ref, f), f


def test_forced_full_rejection(engines):
    """A draft whose lm head is negated (its argmax is the full model's
    argmin) has every draft rejected, and the tokens stay the plain
    serve's."""
    _, shared = engines()
    te = tengine.InferenceEngine(shared.cfg, shared.params,
                                 device=shared.device, max_batch=3,
                                 block_size=4, chunk_tokens=8)
    head = te.params["lm_head"]
    assert isinstance(head, LowRankQ)
    # the cascade applies s2 before its requantization, so negating it
    # negates the logits exactly
    bad = dict(te.params, lm_head=LowRankQ(head.w1, dataclasses.replace(
        head.w2, scale=-head.w2.scale)))
    te.speculation = tspec.SpeculationController(
        tspec.DraftSpec(k=2), te.cfg, te.params, draft_params=bad)
    prompts = _prompts(te.cfg.vocab_size, seed=2)
    sp = tengine.SamplingParams(max_tokens=6)
    on = te.serve(prompts, sp)
    _same_tokens(on, te.serve(prompts, sp, speculate=False))
    assert on.drafted > 0 and on.accepted == 0


def test_exact_draft_accepts_every_draft(engines):
    """A draft that is the served model itself (rank fraction 1.0) has
    every draft accepted, so each round emits up to k + 1 tokens and
    commits its draft blocks: the plain serve's tokens in fewer steps."""
    _, shared = engines()
    te = tengine.InferenceEngine(shared.cfg, shared.params,
                                 device=shared.device, max_batch=3,
                                 block_size=4, chunk_tokens=8,
                                 speculate=tspec.DraftSpec(
                                     k=3, rank_fraction=1.0))
    assert te.speculation.exact
    prompts = _prompts(te.cfg.vocab_size, seed=3)
    sp = tengine.SamplingParams(max_tokens=10)
    on = te.serve(prompts, sp)
    off = te.serve(prompts, sp, speculate=False)
    _same_tokens(on, off)
    assert on.drafted > 0 and on.accept_rate == 1.0
    assert on.steps < off.steps


def test_sampled_rows_never_draft_and_mix_with_greedy(engines):
    """An all-sampled batch drafts nothing; in a mixed batch the greedy
    rows draft, and every row's tokens equal the plain serve's and the
    reference's speculative serve's."""
    je, te = engines()
    prompts = _prompts(te.cfg.vocab_size, seed=8)
    hot = tengine.SamplingParams(max_tokens=4, temperature=0.7, top_k=8,
                                 seed=3)
    res = te.serve(prompts[:2], hot)
    assert res.drafted == 0 and res.spec_rounds == 0

    def reqs(mod):
        return [mod.Request(tokens=p, temperature=0.0 if i % 2 else 0.9,
                            top_k=15, top_p=0.95, seed=13)
                for i, p in enumerate(prompts)]

    on = te.serve(reqs(tengine), tengine.SamplingParams(max_tokens=6))
    assert on.drafted > 0
    _same_tokens(on, te.serve(reqs(tengine),
                              tengine.SamplingParams(max_tokens=6),
                              speculate=False))
    _same_tokens(on, je.serve(reqs(jengine),
                              jengine.SamplingParams(max_tokens=6)))


def test_speculative_stops_match_host_oracle(engines):
    """eos and stop sequences under speculation truncate each output to
    `match_stop_host` over the run without stops, and stream the same
    tokens through on_token."""
    _, te = engines()
    prompts = _prompts(te.cfg.vocab_size, seed=9)
    full = [o.copy() for o in te.serve(
        prompts, tengine.SamplingParams(max_tokens=8)).outputs]
    eos = int(full[0][1])
    stops = ((int(full[1][2]), int(full[1][3])),)
    events = []
    res = te.serve(prompts, tengine.SamplingParams(
        max_tokens=8, eos_id=eos, stop=stops), on_token=events.append)
    assert res.spec_rounds > 0
    hit = 0
    for i, out in enumerate(res.outputs):
        keep = tsmp.match_stop_host(full[i], eos, stops, 8)
        hit += keep < 8
        np.testing.assert_array_equal(out, full[i][:keep], f"request {i}")
        evs = [e for e in events if e.rid == i]
        assert [e.token for e in evs] == out.tolist()
        assert [e.index for e in evs] == list(range(out.size))
        assert [e.final for e in evs] == [False] * (out.size - 1) + [True]
    assert hit > 0 and res.stopped_early == hit


def test_build_speculate_resolution(bridged):  # noqa: F811
    _, _, tparams, _ = bridged
    cfg = t_get_config("opus-mt", smoke=True)

    def build(speculate, plan=None):
        return tengine.InferenceEngine.build(cfg, plan, params=tparams,
                                             device="cpu",
                                             speculate=speculate)

    assert build(2).speculation.spec == tspec.DraftSpec(k=2)
    assert build(True).speculation.spec == tspec.DraftSpec()
    assert build(False).speculation is None
    assert build(None).speculation is None
    eng = build(None)
    with pytest.raises(ValueError, match="no draft model"):
        eng.serve([np.arange(1, 5)], tengine.SamplingParams(max_tokens=2),
                  speculate=True)
    plan = tplan.CompressionPlan(label="empty",
                                 draft=tspec.DraftSpec(k=5))
    assert tengine._resolve_speculate(None, plan).k == 5
    assert tengine._resolve_speculate(True, plan).k == 5
    assert tengine._resolve_speculate(0, plan) is None


def test_cli_serves_speculatively_on_cpu(capsys):
    res = tserve.main(["--arch", "opus-mt", "--smoke", "--device", "cpu",
                       "--batch", "3", "--max-batch", "2", "--prompt-len",
                       "10", "--gen", "5", "--speculate", "2",
                       "--draft-rank-fraction", "0.5", "--ragged"])
    assert res.spec_k == 2
    assert "speculation k=2" in capsys.readouterr().out


# ---------------------------------------------- scheduler reservations --

def _live_seq(mod, pool, prompt_len, max_tokens, n_emitted):
    """A decoding row holding exactly the blocks its committed context
    needs (not the admission worst case)."""
    req = mod.Request(tokens=np.ones(prompt_len, np.int32),
                      max_tokens=max_tokens, rid=0)
    committed = prompt_len + max(n_emitted - 1, 0)
    seq = mod.Sequence(req=req, row=0, block_ids=pool.alloc(
        -(-committed // pool.block_size)))
    seq.prefilled = prompt_len
    seq.n_emitted = n_emitted
    return seq


def _replay(case, mod, kv):
    """One reserve/commit scenario on `mod`'s scheduler; returns what it
    observed."""
    nb, bs, prompt, max_tok, emitted, k, accept = case
    pool = kv.BlockPool(nb, bs)
    sched = mod.Scheduler(pool, 1)
    seq = _live_seq(mod, pool, prompt, max_tok, emitted)
    base = list(seq.block_ids)
    got = sched.reserve_speculation(seq, k)
    obs = [got, list(seq.block_ids), list(seq.draft_blocks), pool.available]
    seq.n_emitted += accept
    obs += [sched.commit_speculation(seq), list(seq.block_ids),
            list(seq.draft_blocks), pool.available, base,
            sched.commit_speculation(seq)]
    return obs


@pytest.mark.parametrize("case", [
    (16, 4, 6, 4, 3, 4, 1),     # one token left: no draft at all
    (16, 4, 6, 4, 2, 4, 1),     # two left: k clamps to 1
    (16, 4, 7, 8, 1, 4, 1),     # full rejection rolls the blocks back
    (16, 2, 4, 8, 1, 3, 3),     # kept: blocks the accepted prefix reached
    (4, 2, 4, 10, 1, 4, 1),     # the draft shrinks to the pool's capacity
    (16, 4, 8, 12, 4, 4, 5),    # full acceptance keeps every draft block
])
def test_reserve_and_commit_equal_reference(case):
    """The draft-block reservation and its rollback give the reference
    scheduler's grants, block ids and pool counts, case by case."""
    got = _replay(case, tsched, tkv)
    want = _replay(case, jsched, jkv)
    assert got == want
    assert 0 not in got[2]


def test_schedule_offers_drafts_like_reference():
    """schedule(spec_k): decode rows get drafts out of the budget left by
    prefill chunks, sampled rows none; max_span and total_tokens count
    the drafts; a row holding draft blocks is never a preemption
    victim."""
    outs = []
    for mod, kv in ((tsched, tkv), (jsched, jkv)):
        sched = mod.Scheduler(kv.BlockPool(64, 4), 4)
        for i, (n, temp) in enumerate(((5, 0.0), (6, 0.8), (7, 0.0))):
            sched.submit(mod.Request(tokens=np.ones(n, np.int32),
                                     max_tokens=8, rid=i, temperature=temp))
        plans = []
        for budget in (32, 6, 3):
            plan = sched.schedule(budget, spec_k=3)
            for r, w in plan.prefill.items():
                sched.advance_prefill(sched.rows[r], w)
            for r in list(plan.prefill) + plan.decode:
                seq = sched.rows[r]
                if seq.prefill_done:
                    seq.n_emitted += 1 + plan.spec.get(r, 0)
            plans.append((dict(plan.prefill), list(plan.decode),
                          dict(plan.spec), plan.max_span,
                          plan.total_tokens))
        outs.append(plans)
        from repro_torch.runtime import elastic
        drafting = [s for s in sched.rows if s is not None
                    and s.draft_blocks]
        for s in drafting:
            s.n_emitted = 0
        assert not set(map(id, elastic.preemption_victims(sched.rows))) & \
            set(map(id, drafting))
    assert outs[0] == outs[1]
    assert any(p[2] for p in outs[0])
    assert all(1 not in p[2] for p in outs[0])     # row 1 samples

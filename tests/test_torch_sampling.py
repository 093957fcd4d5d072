"""The port's sampling and stop criteria (`repro_torch.runtime.prng`,
`repro_torch.runtime.sampling`, the sampled `serve_step` and `serve`) held
to the JAX reference on the same inputs, on the CPU.

Tolerances: none. Threefry bits, keys and stop masks are integers and
must be equal; sampled tokens must be equal (the port's float64 sampler
differs from the reference's float32 one only where a comparison falls
within float32 rounding of its threshold, which these seeds do not meet);
served tokens must be equal, as must the scheduling counters.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import bridged  # noqa: F401 (the shared fixture)

from repro.api import engine as jengine
from repro.models import transformer as jtfm
from repro.runtime import kvblocks as jkv
from repro.runtime import sampling as jsmp
from repro_torch.api import engine as tengine
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttfm
from repro_torch.runtime import kvblocks as tkv
from repro_torch.runtime import prng
from repro_torch.runtime import sampling as tsmp
from repro_torch.runtime.scheduler import Request as TRequest

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

TINY = float(np.finfo(np.float32).tiny)
SAMPLED = dict(max_tokens=6, temperature=0.9, top_k=20, top_p=0.9, seed=7)


def _key_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


# ----------------------------------------------------------- threefry --

@pytest.mark.parametrize("seed", [0, 1, -1, 2**31 - 1, -2**31])
def test_prng_bits_equal_jax_random(seed):
    """prng_key, fold_in chains (negative data wraps as uint32) and the
    scalar uniform with minval=tiny give jax.random's bits exactly."""
    jk = jax.random.PRNGKey(seed)
    tk = prng.prng_key(torch.tensor(seed, dtype=torch.int32))
    np.testing.assert_array_equal(tk.numpy(), _key_words(jk))
    for data in (0, 1, 31999, -7, 2**31 - 1):
        jk = jax.random.fold_in(jk, jnp.int32(data))
        tk = prng.fold_in(tk, data)
        np.testing.assert_array_equal(tk.numpy(), _key_words(jk),
                                      err_msg=f"fold_in {data}")
        ju = jax.random.uniform(jk, minval=jnp.finfo(jnp.float32).tiny)
        tu = prng.uniform(tk, TINY)
        assert np.asarray(ju).view(np.int32) == tu.numpy().view(np.int32)
        ju0 = jax.random.uniform(jk)
        assert np.asarray(ju0).view(np.int32) == \
            prng.uniform(tk).numpy().view(np.int32)


def test_row_keys_equal_reference():
    rng = np.random.default_rng(0)
    seed = rng.integers(-2**31, 2**31 - 1, 64).astype(np.int32)
    rid = rng.integers(0, 1000, 64).astype(np.int32)
    ctr = rng.integers(0, 4096, 64).astype(np.int32)
    want = np.asarray(jsmp.row_keys(jnp.asarray(seed), jnp.asarray(rid),
                                    jnp.asarray(ctr))).astype(np.int64)
    got = tsmp.row_keys(_t(seed), _t(rid), _t(ctr)).numpy()
    np.testing.assert_array_equal(got, want)


def test_f32_bits_and_unpack_meta_roundtrip():
    buf = np.zeros((2, 5 + tsmp.SAMP_COLS), np.int32)
    req = TRequest(tokens=[1, 2], max_tokens=9, rid=3, temperature=0.7,
                   top_k=5, top_p=0.85, seed=-4, eos_id=2)
    tsmp.write_row_meta(buf, 1, req, counter=6)
    meta = tsmp.unpack_meta(_t(buf))
    jmeta = jsmp.unpack_meta(jnp.asarray(buf))
    for k, v in meta.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jmeta[k]), k)
    assert meta["temperature"][1].item() == np.float32(0.7)
    assert meta["top_p"][1].item() == np.float32(0.85)
    assert meta["eos"][0].item() == 0 and meta["eos"][1].item() == 2


# ------------------------------------------------------------ sampler --

ROW_TEMP = [0.0, 0.7, 1.5, 0.7, 1.5, 0.7, 1.5, 0.7, 1.5, 0.7, 1.5, 0.9]
ROW_TOPK = [0, 0, 1, 40, 256, 300, 0, 40, 256, 0, 300, 0]
ROW_TOPP = [1.0, 0.3, 0.9, 1.0, 0.3, 0.9, 1.0, 0.9, 0.9, 0.3, 1.0, 1.0]


@pytest.mark.parametrize("vocab", [32000, 100])
def test_sample_tokens_equal_reference(vocab):
    """Rows mixing temperature 0 / 0.7 / 1.5, top_k 0 / 1 / 40 / 256 / 300
    and top_p 0.3 / 0.9 / 1.0 draw the reference's tokens, over several
    key sets. The last row's logits are integers, so hundreds of tokens
    tie at the 256-wide window's edge and inside it (and at V 100 the
    window is the whole vocabulary)."""
    rng = np.random.default_rng(vocab)
    b = len(ROW_TEMP)
    logits = (rng.standard_normal((b, vocab)) * 3).astype(np.float32)
    logits[-1] = np.round(logits[-1])
    temp = np.asarray(ROW_TEMP, np.float32)
    topk = np.asarray(ROW_TOPK, np.int32)
    topp = np.asarray(ROW_TOPP, np.float32)
    jl = jnp.asarray(logits)
    for trial in range(4):
        seed = rng.integers(-2**31, 2**31 - 1, b).astype(np.int32)
        rid = rng.integers(0, 100, b).astype(np.int32)
        ctr = rng.integers(0, 50, b).astype(np.int32)
        jkeys = jsmp.row_keys(jnp.asarray(seed), jnp.asarray(rid),
                              jnp.asarray(ctr))
        want = np.asarray(jsmp.sample_tokens(
            jl, jnp.asarray(temp), jnp.asarray(topk), jnp.asarray(topp),
            jkeys))
        got = tsmp.sample_tokens(_t(logits), _t(temp), _t(topk), _t(topp),
                                 tsmp.row_keys(_t(seed), _t(rid), _t(ctr)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"trial {trial}")
        assert got[0].item() == int(np.argmax(logits[0]))


def test_candidate_window_is_lax_top_k():
    """The window's members and order equal lax.top_k's, ties and signed
    zeros included (+0.0 ranks above -0.0, the lower id first)."""
    x = np.asarray([[1.0, 0.0, -0.0, 1.0, 2.0, 0.0, -0.0, 1.0],
                    [-0.0, 0.0, -0.0, 0.0, 3.0, 3.0, -1.0, 3.0]],
                   np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 6)
    cand, idx = tsmp.lax_top_k(_t(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(cand.numpy().view(np.int32),
                                  np.asarray(wv).view(np.int32))


# ------------------------------------------------------- stop criteria --

def test_stop_helpers_equal_reference():
    """push_recent, pack_stop_seqs, finished_mask and match_stop_host on
    random rings, counters, eos ids and stop sets."""
    rng = np.random.default_rng(3)
    b, s, ns = 16, 3, 2
    recent = rng.integers(0, 4, (b, s)).astype(np.int32)
    toks = rng.integers(0, 4, (b, 1)).astype(np.int32)
    stops = np.stack([tsmp.pack_stop_seqs(
        tuple(tuple(int(t) for t in rng.integers(0, 4, rng.integers(1, 4)))
              for _ in range(rng.integers(0, ns + 1))), ns, s)
        for _ in range(b)])
    for r in range(b):
        ss = [tuple(int(t) for t in row[row >= 0]) for row in stops[r]
              if (row >= 0).any()]
        np.testing.assert_array_equal(
            stops[r], jsmp.pack_stop_seqs(tuple(ss), ns, s))
    meta = {"counter": rng.integers(0, 4, b).astype(np.int32),
            "eos": rng.integers(-1, 4, b).astype(np.int32),
            "max_tokens": rng.integers(0, 5, b).astype(np.int32)}
    jr = jsmp.push_recent(jnp.asarray(recent), jnp.asarray(toks))
    tr = tsmp.push_recent(_t(recent), _t(toks))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    want = jsmp.finished_mask(jnp.asarray(toks[:, 0]), jr,
                              {k: jnp.asarray(v) for k, v in meta.items()},
                              jnp.asarray(stops))
    got = tsmp.finished_mask(_t(toks[:, 0]), tr,
                             {k: _t(v) for k, v in meta.items()},
                             _t(stops))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < b
    for _ in range(200):
        stream = rng.integers(0, 4, rng.integers(1, 9)).tolist()
        eos = None if rng.random() < 0.5 else int(rng.integers(0, 4))
        st = tuple(tuple(int(t) for t in rng.integers(0, 4,
                                                      rng.integers(1, 4)))
                   for _ in range(rng.integers(0, 3)))
        mt = None if rng.random() < 0.3 else int(rng.integers(1, 9))
        assert tsmp.match_stop_host(stream, eos, st, mt) == \
            jsmp.match_stop_host(stream, eos, st, mt)


# --------------------------------------------------------- serve_step --

@pytest.mark.parametrize("sample,stop", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_serve_step_equal_reference(bridged, sample, stop):  # noqa: F811
    """Two steps (a ragged prefill with an idle row, then decode fed from
    `prev`) of `serve_step(sample, stop)` give the reference's tokens,
    finished mask and ring."""
    cfg, jparams, tparams, _ = bridged
    tcfg = t_get_config("opus-mt", smoke=True)
    m = tsmp.SAMP_COLS
    rng = np.random.default_rng(5)
    ql = np.array([7, 3, 0], np.int32)
    table = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    buf = np.zeros((3, 8 + 3 + m), np.int32)
    buf[:, :8] = rng.integers(1, cfg.vocab_size, (3, 8))
    buf[:, -(m + 2)] = ql
    reqs = [TRequest(tokens=[1], max_tokens=2, rid=0, temperature=0.8,
                     top_k=0, top_p=0.9, seed=11, eos_id=None),
            TRequest(tokens=[1], max_tokens=5, rid=1, temperature=0.0,
                     top_k=3, top_p=1.0, seed=11, eos_id=7)]
    stops = np.full((3, 1, 2), -1, np.int32)
    stops[1, 0] = [4, 9]
    jpool = jkv.init_paged_cache(cfg, 7, 4)
    tpool = tkv.init_paged_cache(tcfg, 7, 4, "cpu")
    jprev = jnp.zeros((3, 1), jnp.int32)
    jrec = jnp.zeros((3, 2), jnp.int32)
    tprev = torch.zeros((3, 1), dtype=torch.int32)
    trec = torch.zeros((3, 2), dtype=torch.int32)
    for step in range(2):
        for r, req in enumerate(reqs):
            tsmp.write_row_meta(buf, r, req, counter=step)
        jt, jf, jrec, jpool = jtfm.serve_step(
            jparams, jpool, jnp.asarray(table), jnp.asarray(buf), jprev,
            jrec, jnp.asarray(stops), cfg, sample=sample, stop=stop)
        tt, tf, trec, tpool = ttfm.serve_step(
            tparams, tpool, _t(table), _t(buf), tprev, trec, _t(stops),
            tcfg, sample=sample, stop=stop)
        np.testing.assert_array_equal(tt.numpy()[:2], np.asarray(jt)[:2],
                                      err_msg=f"step {step}")
        if stop:
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
            np.testing.assert_array_equal(trec.numpy()[:2],
                                          np.asarray(jrec)[:2])
        else:
            assert tf is None
        jprev, tprev = jt, tt
        buf[:, :8] = 0
        buf[:, -(m + 3)] += ql
        ql = np.array([1, 1, 0], np.int32)
        buf[:, -(m + 2)] = ql
        buf[:, -(m + 1)] = ql


# -------------------------------------------------------------- serve --

def _prompts(vocab, seed=0, lens=(5, 11, 3, 14, 8)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def engines(bridged):  # noqa: F811
    """(reference engine, port engine) per kv_bits, built once a module so
    the reference's jitted steps compile once."""
    cfg, jparams, tparams, _ = bridged
    made = {}

    def get(kv_bits=16):
        if kv_bits not in made:
            made[kv_bits] = (
                jengine.InferenceEngine(
                    dataclasses.replace(cfg, kv_cache_bits=kv_bits), jparams,
                    max_batch=3, block_size=4, chunk_tokens=8),
                tengine.InferenceEngine.build(
                    t_get_config("opus-mt", smoke=True), None,
                    params=tparams, device="cpu", kv_bits=kv_bits,
                    max_batch=3, block_size=4, chunk_tokens=8))
        return made[kv_bits]

    return get


def _same(a, b, fields=("steps", "prefill_chunks", "mixed_steps",
                        "stopped_early")):
    for i, (x, y) in enumerate(zip(a.outputs, b.outputs)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")
    for f in fields:
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_seeded_sampled_serve_equal_reference(engines, kv_bits):
    """A seeded sampled serve gives the reference's tokens; it replays,
    a different seed changes it, and prefix cache on and off agree."""
    je, te = engines(kv_bits)
    prompts = _prompts(te.cfg.vocab_size)
    sp = tengine.SamplingParams(**SAMPLED)
    got = te.serve(prompts, sp)
    _same(got, je.serve(prompts, jengine.SamplingParams(**SAMPLED)))
    _same(got, te.serve(prompts, sp, prefix_cache=False))
    other = te.serve(prompts, dataclasses.replace(sp, seed=8))
    assert any(not np.array_equal(a, b)
               for a, b in zip(got.outputs, other.outputs))


def test_prefix_cache_sampled_identity(engines):
    """Requests sharing a 12-token prefix (3 full blocks): the cache hits,
    and the sampled tokens equal the uncached serve's and the
    reference's."""
    je, te = engines()
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, te.cfg.vocab_size, 12).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        1, te.cfg.vocab_size, 2 + i % 4).astype(np.int32)])
        for i in range(5)]
    sp = tengine.SamplingParams(**SAMPLED)
    on = te.serve(prompts, sp, prefix_cache=True)
    assert on.cache_hit_blocks > 0
    _same(on, te.serve(prompts, sp, prefix_cache=False), ("stopped_early",))
    _same(on, je.serve(prompts, jengine.SamplingParams(**SAMPLED),
                       prefix_cache=True), ("steps", "cache_hit_blocks"))


@pytest.mark.parametrize("sampled", [False, True])
def test_stop_truncation_equal_reference(engines, sampled):
    """eos and a 2-token stop sequence, taken from the run without stops:
    each output is `match_stop_host` of that run, and equals the
    reference's, early-stop count included."""
    je, te = engines()
    prompts = _prompts(te.cfg.vocab_size, seed=6)
    base = dict(SAMPLED, max_tokens=10) if sampled else dict(max_tokens=10)
    full = [o.copy() for o in te.serve(
        prompts, tengine.SamplingParams(**base)).outputs]
    eos = int(full[0][1])
    stops = ((int(full[1][2]), int(full[1][3])), (int(full[2][0]),))
    got = te.serve(prompts, tengine.SamplingParams(**base, eos_id=eos,
                                                   stop=stops))
    hit = 0
    for i, out in enumerate(got.outputs):
        keep = tsmp.match_stop_host(full[i], eos, stops, 10)
        hit += keep < 10
        np.testing.assert_array_equal(out, full[i][:keep], f"request {i}")
    assert hit > 0 and got.stopped_early == hit
    _same(got, je.serve(prompts, jengine.SamplingParams(
        **base, eos_id=eos, stop=stops)))


def test_per_request_overrides_equal_reference(engines):
    """Request fields override the call's: a greedy row among sampled
    ones keeps its greedy tokens, a per-request eos stops only that
    request, and the freed row admits the next one."""
    je, te = engines()
    prompts = _prompts(te.cfg.vocab_size, seed=7, lens=(5, 7, 4, 9))
    greedy = te.serve(prompts, tengine.SamplingParams(max_tokens=8))
    eos = int(greedy.outputs[0][1])

    def reqs(mod):
        return [mod.Request(tokens=prompts[0], eos_id=eos),
                mod.Request(tokens=prompts[1], temperature=0.0),
                mod.Request(tokens=prompts[2], stop=((7, 7),)),
                mod.Request(tokens=prompts[3], seed=3)]

    sp = dict(SAMPLED, max_tokens=8)
    got = te.serve(reqs(tengine), tengine.SamplingParams(**sp))
    np.testing.assert_array_equal(got.outputs[1], greedy.outputs[1])
    _same(got, je.serve(reqs(jengine), jengine.SamplingParams(**sp)))


def test_token_events_reproduce_outputs(engines):
    """on_token streams every output token once, in order, the last one
    final; serve_stream yields the same events and closes with the
    result. Both equal the reference engine's streams."""
    je, te = engines()
    prompts = _prompts(te.cfg.vocab_size, seed=10, lens=(5, 9, 3))
    stop = dict(SAMPLED, stop=((5, 6),))
    tev, jev = [], []
    got = te.serve(prompts, tengine.SamplingParams(**stop),
                   on_token=tev.append)
    je.serve(prompts, jengine.SamplingParams(**stop), on_token=jev.append)
    assert [(e.rid, e.token, e.index, e.final) for e in tev] == \
        [(e.rid, e.token, e.index, e.final) for e in jev]
    for rid, out in enumerate(got.outputs):
        evs = [e for e in tev if e.rid == rid]
        assert [e.token for e in evs] == out.tolist()
        assert [e.final for e in evs] == [False] * (len(evs) - 1) + [True]

    async def drive():
        items = []
        async for item in tserve.serve_stream(
                te, prompts, tengine.SamplingParams(**stop)):
            items.append(item)
        return items

    items = asyncio.run(drive())
    assert isinstance(items[-1], tengine.ServeResult)
    assert [(e.rid, e.token, e.index, e.final) for e in items[:-1]] == \
        [(e.rid, e.token, e.index, e.final) for e in tev]


def test_slo_metrics_consistent(engines):
    _, te = engines()
    prompts = _prompts(te.cfg.vocab_size, seed=12)
    full = te.serve(prompts, tengine.SamplingParams(max_tokens=8))
    eos = int(full.outputs[0][1])
    res = te.serve(prompts, tengine.SamplingParams(max_tokens=8, eos_id=eos))
    assert res.stopped_early >= 1
    assert res.queue_p95 >= res.queue_p50 >= 0.0
    assert res.ttft_p95 >= res.ttft_p50 and res.tpot_p95 >= res.tpot_p50
    deadlines = [0.0, max(res.finish_times) / 2, max(res.finish_times) + 1]
    gp = [res.goodput(d) for d in deadlines]
    assert gp == sorted(gp) and gp[0] == 0.0
    assert gp[-1] == pytest.approx(res.tokens_per_second)
    assert res.slo_attainment(1e9, 1e9) == 1.0


def test_sampling_params_validation_and_json():
    for bad in (dict(top_p=0.0), dict(top_p=1.5), dict(top_k=-1),
                dict(eos_id=-2), dict(stop=((1, 2), ())),
                dict(max_tokens=0)):
        with pytest.raises(ValueError):
            tengine.SamplingParams(**bad)
        with pytest.raises(ValueError):
            jengine.SamplingParams(**bad)
    sp = tengine.SamplingParams(max_tokens=9, temperature=0.7, top_k=5,
                                top_p=0.85, seed=3, eos_id=2,
                                stop=((4, 5), (6,)))
    d = sp.to_dict()
    assert d == jengine.SamplingParams.from_dict(d).to_dict()
    assert tengine.SamplingParams.from_dict(d) == sp


def test_cli_serves_sampled_and_streamed_on_cpu(capsys):
    res = tserve.main(["--arch", "opus-mt", "--smoke", "--device", "cpu",
                       "--batch", "3", "--max-batch", "2", "--prompt-len",
                       "10", "--gen", "5", "--temperature", "0.8",
                       "--top-k", "40", "--top-p", "0.9", "--eos-id", "3",
                       "--stop", "5,6", "--stream", "--ragged"])
    out = capsys.readouterr().out
    assert "[stream] rid=" in out and "(final)" in out
    assert all(1 <= o.size <= 5 for o in res.outputs)

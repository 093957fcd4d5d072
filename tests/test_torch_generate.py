"""The rectangular path of the port (attention's K/V, the contiguous decode
cache, `prefill` / `decode_step`, `InferenceEngine.generate`, the lockstep
CLI) and its `data.pipeline`, against the reference on the same weights.

Weights are smoke-size opus-mt from the reference's seed 0, dense or
compressed by the reference, saved with its checkpoint module and read by
`repro_torch.bridge`. The reference runs jitted: XLA turns its division of
the K/V absmax by 127 into a multiply by the float32 reciprocal, which is
what the port takes (an eager reference differs in the last bit of a few
percent of scales)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import engine as jengine
from repro.api import plan as jplan
from repro.checkpoint import ckpt
from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.api import engine as tengine
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.runtime.sampling import match_stop_host

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

CPU = torch.device("cpu")
WINDOWS = [None, 8]
SAMPLED = dict(max_tokens=6, temperature=0.8, top_k=20, top_p=0.9, seed=3)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{plan: (reference params, port params)} for the dense model, the
    quantization-only W4A8 baseline and ITERA W4 at rank fraction 0.5
    (packed where the packing rule allows)."""
    cfg = j_get_config("opus-mt", smoke=True)
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    plans = {"dense": None,
             "quant": jplan.CompressionPlan.uniform(params, method="quant",
                                                    weight_wl=4),
             "itera": jplan.CompressionPlan.uniform(
                 params, method="itera", weight_wl=4, rank_fraction=0.5)}
    out = {}
    for name, plan in plans.items():
        jp = jengine.InferenceEngine.build(cfg, plan, params=params).params
        path = tmp_path_factory.mktemp(f"ckpt_{name}")
        ckpt.save(str(path), 0, jp)
        out[name] = (jp, bridge.load_checkpoint(str(path)))
    return out


def _cfgs(kv_bits=16, window=None):
    over = dict(kv_cache_bits=kv_bits, attn_window=window)
    return (dataclasses.replace(j_get_config("opus-mt", smoke=True), **over),
            dataclasses.replace(t_get_config("opus-mt", smoke=True), **over))


def _layer0(jp, tp):
    """Layer 0's attention weights on both sides."""
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"])["attn"],
            ttfm.split_layers(tp, 2)["layers"][0]["attn"])


def _hidden(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_cache_equal(got, want, what):
    """int8 codes and fp32 scales bit for bit; fp32 K/V within 1e-6."""
    assert set(got) == set(want), what
    for name, w in want.items():
        g, w = got[name].numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
        if name in ("ks", "vs") or g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=f"{what} {name}")


def _prompts(vocab, b=3, s=11, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------ attention --
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_attention_return_kv_matches_reference(models, kv_bits, window):
    """Dense weights: y within 1e-5, the returned (k, v) within 1e-6; at
    kv 8 attention runs over the K/V's int8 round trip on both sides."""
    jc, tc = _cfgs(kv_bits, window)
    jl, tl = _layer0(*models["dense"])
    x = _hidden((2, 12, jc.d_model), 1)
    yj, (kj, vj) = jax.jit(lambda p, x: jattn.attention(
        p, x, jc, window=window, return_kv=True))(jl, jnp.asarray(x))
    yt, (kt, vt) = tattn.attention(tl, torch.from_numpy(x), tc,
                                   window=window, return_kv=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
    for got, want in ((kt, kj), (vt, vj)):
        assert tuple(got.shape) == (2, 12, tc.num_kv_heads, tc.head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    # without return_kv the output is the plain attention's
    y0 = tattn.attention(tl, torch.from_numpy(x), tc, window=window)
    if kv_bits == 16:
        assert torch.equal(y0, yt)


@pytest.mark.parametrize("window,s", [(None, 12), (8, 12), (8, 5)])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_cache_layout_matches_reference(kv_bits, window, s):
    """build_cache_from_kv on the same (k, v): a non-rolling cache of 20
    slots, a rolling one of 8 that wraps (S 12) or is part filled (S 5);
    and init_kv_cache."""
    jc, tc = _cfgs(kv_bits)
    quant = kv_bits == 8
    k = _hidden((2, s, tc.num_kv_heads, tc.head_dim), 2) * 3
    v = _hidden((2, s, tc.num_kv_heads, tc.head_dim), 3)
    want = jax.jit(lambda k, v: jattn.build_cache_from_kv(
        k, v, window=window, max_len=20, quantized=quant))(jnp.asarray(k),
                                                            jnp.asarray(v))
    got = tattn.build_cache_from_kv(torch.from_numpy(k), torch.from_numpy(v),
                                    window=window, max_len=20,
                                    quantized=quant)
    _assert_cache_equal(got, want, "build_cache_from_kv")
    _assert_cache_equal(tattn.init_kv_cache(tc, 2, 20, window=window),
                        jattn.init_kv_cache(jc, 2, 20, window=window),
                        "init_kv_cache")


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_decode_attention_matches_reference(models, kv_bits, window):
    """ITERA weights (integer-exact linears, so the new K/V are the
    reference's bits): three decode tokens after a 12-token prompt, y
    within 1e-5 and the updated cache as `_assert_cache_equal` holds it;
    under the window the cache rolls (8 slots, positions 12-14)."""
    jc, tc = _cfgs(kv_bits, window)
    jl, tl = _layer0(*models["itera"])
    x = _hidden((2, 12, jc.d_model), 4)
    _, kv = jax.jit(lambda p, x: jattn.attention(
        p, x, jc, window=window, return_kv=True))(jl, jnp.asarray(x))
    jcache = jax.jit(lambda k, v: jattn.build_cache_from_kv(
        k, v, window=window, max_len=16, quantized=kv_bits == 8))(*kv)
    tcache = _to_torch(jcache)
    step = jax.jit(lambda p, x1, c, pos: jattn.decode_attention(
        p, x1, c, pos, jc, window=window))
    for pos in (12, 13, 14):
        x1 = _hidden((2, 1, jc.d_model), pos)
        yj, jcache = step(jl, jnp.asarray(x1), jcache, jnp.int32(pos))
        yt, tcache = tattn.decode_attention(tl, torch.from_numpy(x1), tcache,
                                            pos, tc, window=window)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=1e-5, err_msg=f"pos {pos}")
        _assert_cache_equal(tcache, jcache, f"cache after pos {pos}")


# ---------------------------------------------------------- transformer --
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("plan", ["dense", "itera"])
def test_prefill_and_decode_logits_match_reference(models, plan, kv_bits,
                                                   window):
    """prefill into a 16-slot cache, then three decode steps fed the
    reference's greedy tokens: logits within 1e-4 at each."""
    jp, tp = models[plan]
    jc, tc = _cfgs(kv_bits, window)
    toks = _prompts(jc.vocab_size, b=2, s=10)
    lj, jcache = jax.jit(lambda p, t: jtfm.prefill(p, t, jc, max_len=16))(
        jp, jnp.asarray(toks))
    lt, tcache = ttfm.prefill(tp, torch.from_numpy(toks), tc, max_len=16)
    assert tuple(lt.shape) == (2, 1, tc.vocab_size)
    assert lt.dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in tcache["kv"].items()} == {
        k: v.shape for k, v in jcache["kv"].items()}
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)
    step = jax.jit(lambda p, c, t, pos: jtfm.decode_step(p, c, t, pos, jc))
    for pos in (10, 11, 12):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
        lj, jcache = step(jp, jcache, jnp.asarray(tok), jnp.int32(pos))
        lt, tcache = ttfm.decode_step(tp, tcache, torch.from_numpy(tok), pos,
                                      tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=1e-4, err_msg=f"pos {pos}")


def test_rectangular_path_refuses_unported_layouts(models, tmp_path):
    """A paired (local/global) config's `init_cache` and `prefill` give
    the reference's cache tree, {"local", "global"} with the local one
    rolling, with prefill's leaves within 1e-4 of the reference's; the
    ssm layout's `decode_step` (falcon-mamba-7b's smoke config, the
    reference's seed-0 weights) gives the reference's logits and SSM
    cache within 1e-4 from the same cache."""
    jc, tc = _cfgs()
    jpair = dataclasses.replace(jc, local_global_period=2, local_window=3)
    pair = dataclasses.replace(tc, local_global_period=2, local_window=3)
    toks = torch.ones((1, 4), dtype=torch.int32)
    p = ttfm.init_params(tc)
    jp, tp = models["dense"]
    for max_len in (2, 8):
        want = jtfm.init_cache(jpair, 1, max_len)
        got = ttfm.init_cache(pair, 1, max_len)
        assert sorted(got) == sorted(want) == ["global", "local"]
        for group in want:
            assert {k: tuple(v.shape) for k, v in got[group].items()} == {
                k: v.shape for k, v in want[group].items()}
    _, jcache = jax.jit(lambda p, t: jtfm.prefill(p, t, jpair, max_len=8))(
        jp, jnp.asarray(toks.numpy()))
    _, tcache = ttfm.prefill(tp, toks, pair, max_len=8)
    for group in jcache:
        for name, leaf in jcache[group].items():
            np.testing.assert_allclose(tcache[group][name].numpy(),
                                       np.asarray(leaf), rtol=0, atol=1e-4,
                                       err_msg=f"{group}/{name}")
    cache = ttfm.init_cache(tc, 1, 8)
    assert cache["kv"]["k"].shape == (2, 1, 8, 4, 16)
    jc = j_get_config("falcon-mamba-7b", smoke=True)
    tc = t_get_config("falcon-mamba-7b", smoke=True)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jc)
    path = tmp_path / "ckpt"
    ckpt.save(str(path), 0, jp)
    tp = bridge.load_checkpoint(str(path))
    _, jcache = jax.jit(lambda p, t: jtfm.prefill(p, t, jc))(
        jp, jnp.asarray(toks.numpy()))
    tcache = {"ssm": {k: torch.from_numpy(np.array(v))
                      for k, v in jcache["ssm"].items()}}
    lj, jcache = jax.jit(lambda p, c, t: jtfm.decode_step(p, c, t, 4, jc))(
        jp, jcache, jnp.asarray(toks.numpy()[:, :1]))
    lt, tcache = ttfm.decode_step(tp, tcache, toks[:, :1], 4, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)
    for name, leaf in jcache["ssm"].items():
        np.testing.assert_allclose(tcache["ssm"][name].numpy(),
                                   np.asarray(leaf), rtol=0, atol=1e-4,
                                   err_msg=name)


# --------------------------------------------------------------- engine --
def _engines(models, plan, kv_bits, window=None, **kw):
    jp, tp = models[plan]
    jc, tc = _cfgs(kv_bits, window)
    return (jengine.InferenceEngine(jc, jp, **kw),
            tengine.InferenceEngine(tc, tp, device=CPU, **kw))


@pytest.mark.parametrize("plan,kv_bits,window", [
    (p, kv, None) for p in ("dense", "quant", "itera") for kv in (16, 8)]
    + [("itera", 16, 8), ("itera", 8, 8)])
def test_generate_greedy_matches_reference(models, plan, kv_bits, window):
    """Greedy tokens of an 11-token batch (bucket 16 without a window)
    identical to the reference engine's, and to the port's unbucketed
    engine's."""
    je, te = _engines(models, plan, kv_bits, window)
    assert te.bucket_prompts == je.bucket_prompts == (window is None)
    prompts = _prompts(je.cfg.vocab_size)
    sp = dict(max_tokens=7)
    want = je.generate(prompts, jengine.SamplingParams(**sp))
    got = te.generate(prompts, tengine.SamplingParams(**sp))
    assert got.tokens.dtype == np.int32 and got.prompt_len == 11
    np.testing.assert_array_equal(got.tokens, want.tokens)
    flat = tengine.InferenceEngine(te.cfg, te.params, device=CPU,
                                   bucket_prompts=False)
    np.testing.assert_array_equal(
        flat.generate(prompts.tolist(), tengine.SamplingParams(**sp)).tokens,
        want.tokens)


def test_generate_ragged_lists_match_reference(models):
    """Ragged prompt lists go through serve: the reference's tokens and
    prompt lengths (int8 KV)."""
    je, te = _engines(models, "itera", 8, max_batch=2, block_size=4,
                      chunk_tokens=8)
    base = _prompts(je.cfg.vocab_size, s=12)
    ragged = [base[0, :12], base[1, :7], base[2, :9]]
    want = je.generate(ragged, jengine.SamplingParams(max_tokens=5))
    got = te.generate(ragged, tengine.SamplingParams(max_tokens=5))
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.prompt_lens == want.prompt_lens == [12, 7, 9]
    assert got.prompt_len == want.prompt_len == 12


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_generate_sampled_and_stopped_match_reference(models, kv_bits):
    """Seeded sampled tokens identical to the reference's generate and to
    the port's own serve of the same prompts; then an eos id and a stop
    sequence from that run: the reference's truncation, which is
    `match_stop_host` of each untruncated row."""
    je, te = _engines(models, "itera", kv_bits)
    prompts = _prompts(je.cfg.vocab_size, b=4, s=9, seed=5)
    want = je.generate(prompts, jengine.SamplingParams(**SAMPLED)).tokens
    got = te.generate(prompts, tengine.SamplingParams(**SAMPLED)).tokens
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got}) > 1
    served = te.serve(list(prompts), tengine.SamplingParams(**SAMPLED))
    np.testing.assert_array_equal(np.stack(served.outputs), got)
    stops = dict(SAMPLED, eos_id=int(got[1, 2]),
                 stop=((int(got[3, 3]), int(got[3, 4])),))
    ws = je.generate(prompts, jengine.SamplingParams(**stops)).tokens
    gs = te.generate(prompts, tengine.SamplingParams(**stops)).tokens
    np.testing.assert_array_equal(gs, ws)
    for row, full in zip(gs, got):
        keep = match_stop_host(full, stops["eos_id"], stops["stop"], 6)
        np.testing.assert_array_equal(row, np.r_[full[:keep],
                                                 np.zeros(6 - keep, int)])
    assert (gs[1] == 0).any() and (gs[3] == 0).any()


def test_as_token_batch_refuses_what_the_reference_refuses():
    for bad, msg in (([], "empty"), ([[1, 2], []], "empty"),
                     ([[[1, 2]], [[3, 4]]], "1-D"),
                     (np.ones((2, 2, 2), np.int32), "batch, seq")):
        for mod in (tengine, jengine):
            with pytest.raises(ValueError, match=msg):
                mod._as_token_batch(bad)
    ragged = tengine._as_token_batch([[1, 2, 3], [4]])
    assert isinstance(ragged, list) and ragged[1].dtype == np.int32
    rect = tengine._as_token_batch([[1, 2], [3, 4]])
    assert rect.shape == (2, 2) and rect.dtype == np.int32


# ------------------------------------------- ROADMAP C1: the serve surface --
@pytest.mark.parametrize("plan", ["dense", "quant", "itera"])
def test_weight_hbm_bytes_matches_reference(models, plan):
    je, te = _engines(models, plan, 16)
    assert te.weight_hbm_bytes() == je.weight_hbm_bytes() > 0


def test_prefix_cache_properties_match_reference(models):
    """cache_hit_token_rate and cache_blocks_saved of one serve with shared
    prefixes (a copy-on-write prompt among them)."""
    je, te = _engines(models, "itera", 16, max_batch=3, block_size=4,
                      chunk_tokens=8)
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, je.cfg.vocab_size, size=12).astype(np.int32)
    reqs = [np.concatenate([prefix, rng.integers(1, 500, size=2 + i)
                            .astype(np.int32)]) for i in range(4)]
    reqs.append(prefix.copy())
    want = je.serve(reqs, jengine.SamplingParams(max_tokens=3))
    got = te.serve(reqs, tengine.SamplingParams(max_tokens=3))
    assert got.cache_blocks_saved == want.cache_blocks_saved > 0
    assert got.cache_hit_token_rate == want.cache_hit_token_rate > 0
    assert got.cache_cow_blocks >= 1


# ----------------------------------------------------------------- data --
@pytest.mark.parametrize("task", ["MarkovTask", "LatentMarkovTask"])
def test_markov_tasks_match_reference(task):
    for vocab, seed, step in ((512, 0, 0), (32000, 3, 7)):
        jt = getattr(jpipe, task)(vocab, seed=seed)
        tt = getattr(tpipe, task)(vocab, seed=seed)
        assert tt.entropy_floor() == jt.entropy_floor()
        want, got = jt.batch(step, 4, 33), tt.batch(step, 4, 33)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32 and got[key].device == CPU
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])


# ------------------------------------------------------------------ CLI --
def test_cli_serves_in_lockstep_on_cpu(capsys):
    """The default mode: MarkovTask prompts through generate, the tokens of
    an engine built by hand from the same seed."""
    argv = ["--arch", "opus-mt", "--smoke", "--device", "cpu", "--batch",
            "3", "--prompt-len", "10", "--gen", "4", "--kv-bits", "8",
            "--seed", "2"]
    res = tserve.main(argv)
    assert isinstance(res, tengine.GenerationResult)
    assert res.tokens.shape == (3, 4) and res.prompt_len == 10
    assert "[serve] generated (3, 4)" in capsys.readouterr().out
    eng = tengine.InferenceEngine.build("opus-mt", None, smoke=True, seed=2,
                                        device="cpu", kv_bits=8)
    prompts = tpipe.MarkovTask(eng.cfg.vocab_size, seed=2).batch(0, 3, 10)
    want = eng.generate(prompts["tokens"].numpy(),
                        tengine.SamplingParams(max_tokens=4))
    np.testing.assert_array_equal(res.tokens, want.tokens)
    for extra in (["--stream"], ["--speculate", "2"]):
        with pytest.raises(SystemExit):
            tserve.main(argv + extra)
    res = tserve.main(argv + ["--ragged", "--chunk-tokens", "16",
                              "--no-prefix-cache"])
    assert res.chunk_tokens == 16 and not res.prefix_cache
    assert res.prompt_lens == [10, 6, 4]


def test_launch_serve_generate_matches_reference(models):
    """The back-compat helper, greedy and sampled at temperature 1."""
    jp, tp = models["itera"]
    jc, tc = _cfgs()
    prompts = _prompts(jc.vocab_size, b=2, s=8, seed=6)
    for greedy in (True, False):
        want = jserve.generate(jp, jc, prompts, 5, greedy=greedy, seed=4)
        got = tserve.generate(tp, tc, prompts, 5, greedy=greedy, seed=4,
                              device="cpu")
        assert got.shape == (2, 5) and got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(want))

"""The port's step graphs (`repro_torch.runtime.graphs`) and what capturing
a step needs of it -- a decode position held on the device, no copy from
the host inside a step, engine-held device state per geometry -- against
the JAX reference on the same weights.

Here on the CPU the runner calls every step eagerly through the same
static tensors and the same copies it captures on the card, so these
tests cover that logic; the captures themselves are checked by
tests/test_torch_gpu.py and chip_smoke.py. Weights: smoke-size opus-mt,
ITERA W4 at rank fraction 0.5 compressed by the reference and read by
`repro_torch.bridge` (the shared `bridged` fixture)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import bridged  # noqa: F401 (the shared fixture)

from repro.api import engine as jengine
from repro.models import transformer as jtfm
from repro.runtime import speculation as jspec
from repro_torch.api import engine as tengine
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import build
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.runtime import graphs
from repro_torch.runtime import kvblocks as tkv
from repro_torch.runtime import prng
from repro_torch.runtime import speculation as tspec

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

SAMPLED = dict(max_tokens=6, temperature=0.8, top_k=20, top_p=0.9, seed=3)
GEOMETRY = dict(max_batch=3, block_size=4, chunk_tokens=8)


def _cfgs(cfg, kv_bits=16, window=None):
    over = dict(kv_cache_bits=kv_bits, attn_window=window)
    return (dataclasses.replace(cfg, **over),
            dataclasses.replace(t_get_config("opus-mt", smoke=True), **over))


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _assert_same(a: dict, b: dict, what):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def _pos(p):
    return torch.tensor(p, dtype=torch.long)


# ------------------------------------------------ positions on the device --
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_decode_attention_device_position_equals_host_int(bridged, kv_bits,
                                                          window):
    """Three decode tokens after a 12-token prompt (under the window the
    8-slot cache rolls): a 0-dim position tensor gives the host int's
    output and cache bit for bit."""
    cfg, _, tparams, _ = bridged
    _, tc = _cfgs(cfg, kv_bits, window)
    layer = ttfm.split_layers(tparams, tc.num_layers)["layers"][0]["attn"]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 12, tc.d_model))
                         .astype(np.float32))
    _, (k, v) = tattn.attention(layer, x, tc, window=window, return_kv=True)
    host = tattn.build_cache_from_kv(k, v, window=window, max_len=16,
                                     quantized=kv_bits == 8)
    dev = _clone(host)
    for p in (12, 13, 14):
        x1 = torch.from_numpy(rng.standard_normal((2, 1, tc.d_model))
                              .astype(np.float32))
        yh, host = tattn.decode_attention(layer, x1, host, p, tc,
                                          window=window)
        yd, dev = tattn.decode_attention(layer, x1, dev, _pos(p), tc,
                                         window=window)
        assert torch.equal(yd, yh), p
        _assert_same(dev, host, f"cache after pos {p}")


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_decode_step_device_position_matches_reference(bridged, kv_bits,
                                                       window):
    """The reference's prefill cache (16 slots; 8 rolling under the
    window), then three decode steps fed the reference's greedy tokens:
    with the position a 0-dim tensor, the logits and cache of the host int
    bit for bit, and the reference's jitted decode_step's logits within
    1e-4 (the rectangular path's tolerance)."""
    cfg, jparams, tparams, _ = bridged
    jc, tc = _cfgs(cfg, kv_bits, window)
    toks = np.random.default_rng(5).integers(1, jc.vocab_size,
                                             (2, 10)).astype(np.int32)
    lj, jcache = jax.jit(lambda p, t: jtfm.prefill(p, t, jc, max_len=16))(
        jparams, jnp.asarray(toks))
    host = {"kv": {k: torch.from_numpy(np.array(v))
                   for k, v in jcache["kv"].items()}}
    dev = {"kv": _clone(host["kv"])}
    step = jax.jit(lambda p, c, t, pos: jtfm.decode_step(p, c, t, pos, jc))
    for p in (10, 11, 12):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
        lj, jcache = step(jparams, jcache, jnp.asarray(tok), jnp.int32(p))
        lh, host = ttfm.decode_step(tparams, host, torch.from_numpy(tok), p,
                                    tc)
        ld, dev = ttfm.decode_step(tparams, dev, torch.from_numpy(tok),
                                   _pos(p), tc)
        assert torch.equal(ld, lh), p
        _assert_same(dev["kv"], host["kv"], f"cache after pos {p}")
        np.testing.assert_allclose(ld.numpy(), np.asarray(lj), rtol=0,
                                   atol=1e-4, err_msg=f"pos {p}")


@pytest.mark.parametrize("minval", [0.0, float(np.finfo(np.float32).tiny),
                                    0.3, -1.5])
def test_uniform_with_host_constants(minval):
    """`prng.uniform` over a grid of keys, its bounds float32 host scalars:
    the bits of the same float32 steps on one-element tensors (how it took
    them before), where 1 - minval rounds too; and at the sampler's
    minvals (0 and the float32 tiny) jax.random.uniform's bits. (At other
    minvals XLA may fuse jax's `f * span + minval` into one rounding.)"""
    seeds = np.arange(-3, 5, dtype=np.int32)
    data = np.arange(0, 4096, 97, dtype=np.int32)
    keys = prng.fold_in(prng.prng_key(torch.from_numpy(seeds))[:, None, :],
                        torch.from_numpy(data)[None, :])
    got = prng.uniform(keys, minval).numpy()
    bits = (prng.random_bits(keys) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(1.0, dtype=torch.float32) - lo
    tensors = torch.maximum(lo, f * span + lo).numpy()
    np.testing.assert_array_equal(got.view(np.int32), tensors.view(np.int32))
    if minval > 0.1 or minval < 0:
        return

    def one(seed, d):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        return jax.random.uniform(k, minval=jnp.float32(minval))

    want = jax.vmap(jax.vmap(one, (None, 0)), (0, None))(
        jnp.asarray(seeds), jnp.asarray(data))
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(want).view(np.int32))


# ------------------------------------------------------------ the runner --
def test_step_graph_without_capture_returns_copies():
    """Without capture a call runs the step on the static inputs, which the
    step advances in place, and returns copies of its outputs."""
    made = []

    def fn(x, n):
        n.add_(1)
        y = x * n
        made.append(y)
        return y, None

    inputs = {"x": torch.arange(3), "n": torch.zeros((), dtype=torch.long)}
    step = graphs.StepGraph(fn, inputs, capture=False)
    first, none = step()
    second, _ = step()
    assert none is None and int(inputs["n"]) == 2
    assert first.tolist() == [0, 1, 2] and second.tolist() == [0, 2, 4]
    assert first.data_ptr() != made[0].data_ptr()
    assert graphs.stats([step]) == {"graphs": 0, "capture_seconds": 0,
                                    "pool_bytes": 0}


def test_capture_counts_are_taken_out_and_replays_add_them():
    """The bookkeeping a capture does with the launch counters: a
    capture's counts are subtracted (no entry left at zero), a replay adds
    them back, so captured runs count what eager runs count."""
    build.reset_launches()
    build.LAUNCHES["lowrank_qmm"] += 2
    before = graphs._snapshot()
    build.LAUNCHES["lowrank_qmm"] += 3
    build.LAUNCHES["quant_matmul"] += 1
    build.LAUNCH_RANKS[128] += 3
    build.LAUNCH_SHAPES["quant_matmul", 512, 512] += 1
    delta = [c - b for c, b in zip(graphs._snapshot(), before)]
    graphs._add(delta, -1)
    assert dict(build.LAUNCHES) == {"lowrank_qmm": 2}
    assert not build.LAUNCH_RANKS and not build.LAUNCH_SHAPES
    for _ in range(4):
        graphs._add(delta)
    assert dict(build.LAUNCHES) == {"lowrank_qmm": 14, "quant_matmul": 4}
    assert dict(build.LAUNCH_RANKS) == {128: 12}
    assert dict(build.LAUNCH_SHAPES) == {("quant_matmul", 512, 512): 4}
    build.reset_launches()


# ------------------------------------------------------------ the engine --
@pytest.fixture(scope="module")
def engines(bridged):  # noqa: F811
    """(reference engine, port engine) per (kv_bits, speculative), built
    once a module so the reference's jitted steps compile once."""
    cfg, jparams, tparams, _ = bridged
    made = {}

    def get(kv_bits=16, speculative=False):
        key = (kv_bits, speculative)
        if key not in made:
            jdraft, tdraft = ((jspec.DraftSpec(k=3), tspec.DraftSpec(k=3))
                              if speculative else (None, None))
            made[key] = (
                jengine.InferenceEngine(
                    dataclasses.replace(cfg, kv_cache_bits=kv_bits), jparams,
                    **GEOMETRY, speculate=jdraft),
                tengine.InferenceEngine.build(
                    t_get_config("opus-mt", smoke=True), None,
                    params=tparams, device="cpu", kv_bits=kv_bits,
                    **GEOMETRY, speculate=tdraft))
        return made[key]

    return get


def _prompts(vocab, lens=(5, 11, 8, 14), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def _same(a, b):
    assert len(a.outputs) == len(b.outputs)
    for i, (x, y) in enumerate(zip(a.outputs, b.outputs)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")


@pytest.fixture(scope="module")
def serve_modes(engines):
    """kv_bits -> {mode: (prompts, sampling dict)}: greedy, sampled,
    stopped (an eos id and a stop sequence from the port's sampled run),
    and prompts sharing a 12-token prefix (three full blocks for the
    prefix cache)."""
    made = {}

    def get(kv_bits):
        if kv_bits not in made:
            port = engines(kv_bits)[1]
            vocab = port.cfg.vocab_size
            prompts = _prompts(vocab)
            out = port.serve(prompts,
                             tengine.SamplingParams(**SAMPLED)).outputs
            prefix = np.random.default_rng(4).integers(1, vocab, 12).astype(
                np.int32)
            shared = [np.concatenate([prefix, p[:3]]) for p in prompts[:3]]
            stop = ((int(out[3][3]), int(out[3][4])),)
            made[kv_bits] = {
                "greedy": (prompts, dict(max_tokens=6)),
                "sampled": (prompts, SAMPLED),
                "stopped": (prompts, dict(SAMPLED, eos_id=int(out[1][2]),
                                          stop=stop)),
                "prefix_cache": (shared + [prefix.copy()], SAMPLED)}
        return made[kv_bits]

    return get


@pytest.mark.parametrize("mode", ["greedy", "sampled", "stopped",
                                  "prefix_cache"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_serve_through_the_runner_matches_reference(engines, serve_modes,
                                                    kv_bits, mode):
    """Each serve mode, twice on one engine (the second on the held
    geometry): the reference engine's tokens both times."""
    je, te = engines(kv_bits)
    prompts, sp = serve_modes(kv_bits)[mode]
    want = je.serve(prompts, jengine.SamplingParams(**sp))
    first = te.serve(prompts, tengine.SamplingParams(**sp))
    _same(first, want)
    assert first.steps == want.steps
    slots = dict(te._serve_slots)
    _same(te.serve(prompts, tengine.SamplingParams(**sp)), want)
    assert all(te._serve_slots[k] is v for k, v in slots.items())
    if mode == "stopped":
        assert first.stopped_early == want.stopped_early > 0
    if mode == "prefix_cache":
        assert first.cache_hit_blocks > 0 and first.cache_cow_blocks >= 1


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_speculative_serve_through_the_runner_matches_reference(engines,
                                                                kv_bits):
    """A speculative serve (k 3), twice on one engine: the reference's
    tokens, steps and accept counts."""
    je, te = engines(kv_bits, speculative=True)
    prompts = _prompts(te.cfg.vocab_size, seed=1)
    want = je.serve(prompts, jengine.SamplingParams(max_tokens=8))
    for _ in range(2):
        got = te.serve(prompts, tengine.SamplingParams(max_tokens=8))
        _same(got, want)
        for f in ("steps", "drafted", "accepted", "spec_rounds"):
            assert getattr(got, f) == getattr(want, f), f
    kinds = {key[0] for slot in te._serve_slots.values()
             for key in slot.graphs}
    assert kinds == {"spec"}


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_second_serve_resets_the_held_pool(engines, kv_bits):
    """The second serve of a geometry reuses the engine's pool, tables and
    step graphs; poisoned between the calls (NaN scales and K/V, stale
    tables), they are reset to a fresh pool's contents: the reference's
    tokens again."""
    je, te = engines(kv_bits)
    prompts = _prompts(te.cfg.vocab_size, seed=2)
    sp = dict(SAMPLED, max_tokens=5)
    want = je.serve(prompts, jengine.SamplingParams(**sp))
    _same(te.serve(prompts, tengine.SamplingParams(**sp)), want)
    key, slot = next(reversed(te._serve_slots.items()))
    steps = dict(slot.graphs)
    with torch.inference_mode():        # the engine's tensors are made so
        for leaf in slot.pool.values():
            leaf.fill_(float("nan") if leaf.is_floating_point() else 77)
        for t in (slot.tables, slot.prev, slot.recent):
            t.fill_(3)
    _same(te.serve(prompts, tengine.SamplingParams(**sp)), want)
    assert next(reversed(te._serve_slots.items())) == (key, slot)
    assert all(slot.graphs[k] is v for k, v in steps.items())


@pytest.mark.parametrize("mode", ["greedy", "sampled", "stopped"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_generate_through_the_runner_matches_reference(engines, kv_bits,
                                                       mode):
    """A rectangular batch (9 tokens, bucket 16) twice on one engine, the
    second on the held decode cache and step: the reference's tokens."""
    je, te = engines(kv_bits)
    prompts = np.stack([p[:9] for p in _prompts(te.cfg.vocab_size,
                                                (9, 9, 10), seed=5)])
    if mode == "stopped":       # an eos id and a stop from a sampled run
        full = te.generate(prompts, tengine.SamplingParams(**SAMPLED))
        sp = dict(SAMPLED, eos_id=int(full.tokens[0, 2]),
                  stop=((int(full.tokens[2, 3]), int(full.tokens[2, 4])),))
    else:
        sp = dict(max_tokens=6) if mode == "greedy" else SAMPLED
    want = je.generate(prompts, jengine.SamplingParams(**sp)).tokens
    got = te.generate(prompts, tengine.SamplingParams(**sp)).tokens
    np.testing.assert_array_equal(got, want)
    held = dict(te._decoders)
    again = te.generate(prompts, tengine.SamplingParams(**sp)).tokens
    np.testing.assert_array_equal(again, want)
    assert all(te._decoders[k] is v for k, v in held.items())
    if mode == "stopped":
        assert (got == 0).any()


def test_held_geometries_are_bounded(bridged):  # noqa: F811
    """An engine keeps the state of its four newest serve geometries and
    its four newest generate geometries, dropping the oldest first."""
    _, _, tparams, _ = bridged
    te = tengine.InferenceEngine.build(
        t_get_config("opus-mt", smoke=True), None, params=tparams,
        device="cpu", **GEOMETRY)
    prompts = _prompts(te.cfg.vocab_size, (6, 7))
    for n in range(1, 7):
        te.serve(prompts, tengine.SamplingParams(max_tokens=4 * n))
        te.generate(np.stack([p[:6] for p in prompts]),
                    tengine.SamplingParams(max_tokens=n + 1))
    assert len(te._serve_slots) == len(te._decoders) == 4
    assert [k[1] for k in te._serve_slots] == [
        tkv.blocks_needed(7, 4 * n, 4) for n in range(3, 7)]
    assert [k[1] for k in te._decoders] == [8 + n + 1 for n in range(3, 7)]


def test_graphs_are_off_on_the_cpu(bridged):  # noqa: F811
    """The CPU never captures, whatever `cuda_graphs` says."""
    _, _, tparams, _ = bridged
    te = tengine.InferenceEngine.build(
        t_get_config("opus-mt", smoke=True), None, params=tparams,
        device="cpu", cuda_graphs=True, **GEOMETRY)
    assert not te.cuda_graphs and te._graph_pool is None
    te.serve(_prompts(te.cfg.vocab_size, (5, 6)),
             tengine.SamplingParams(max_tokens=3))
    assert te.graph_stats()["graphs"] == 0

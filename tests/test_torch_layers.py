"""The port's layers and KV-pool code against the JAX reference, on the
same numpy inputs: float paths within 1e-5 (fp32), index math and the
host-side allocator exactly."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import itera as jitera
from repro.core import quant as jquant
from repro.models import layers as jl
from repro.models import transformer as jtfm
from repro.runtime import kvblocks as jkv
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import itera as titera
from repro_torch.core import quant as tquant
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttfm
from repro_torch.runtime import kvblocks as tkv

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def test_norms_match_reference():
    rng = _rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    tx, tg, tb = map(torch.from_numpy, (x, g, b))
    _close(tl.layernorm(tx, tg, tb), jl.layernorm(x, g, b))
    _close(tl.rmsnorm(tx, tg), jl.rmsnorm(x, g))
    _close(tl.apply_norm(tx, {"gamma": tg, "beta": tb}, "layernorm", 1e-5),
           jl.apply_norm(x, {"gamma": g, "beta": b}, "layernorm", 1e-5))


@pytest.mark.parametrize("act", ["gelu", "swiglu", "relu2", "geglu"])
def test_mlp_matches_reference(act):
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    p = {"up": rng.standard_normal((32, 96)).astype(np.float32) * 0.2,
         "down": rng.standard_normal((96, 32)).astype(np.float32) * 0.1,
         "gate": rng.standard_normal((32, 96)).astype(np.float32) * 0.2}
    if act in ("gelu", "relu2"):
        del p["gate"]
    yj = jl.mlp_apply(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                       p.items()}, act)
    yt = tl.mlp_apply(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v
                                            in p.items()}, act)
    _close(yt, yj)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    import jax

    _close(tl.gelu(torch.from_numpy(x)), jax.nn.gelu(jnp.asarray(x)))


def test_positions_match_reference():
    pos = np.array([[0, 1, 2, 3], [37, 38, 39, 40], [500, 501, 502, 503]],
                   np.int32)
    _close(tl.sinusoidal_emb(torch.from_numpy(pos), 64, torch.float32),
           jl.sinusoidal_emb(jnp.asarray(pos), 64, jnp.float32))
    x = _rng(2).standard_normal((3, 4, 2, 16)).astype(np.float32)
    for pct in (1.0, 0.5):
        _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             10000.0, pct),
               jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, pct))
    s = np.linspace(-100, 100, 50).astype(np.float32)
    _close(tl.softcap(torch.from_numpy(s), 30.0), jl.softcap(s, 30.0))
    _close(tl.softcap(torch.from_numpy(s), 0.0), jl.softcap(s, 0.0))


def test_apply_linear_dispatches_every_node_type():
    """Dense within 1e-5; quantized and low-rank nodes bit for bit (their
    integer paths are exact in both packages)."""
    rng = _rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    _close(tl.apply_linear(torch.from_numpy(x), torch.from_numpy(w)),
           jl.apply_linear(jnp.asarray(x), jnp.asarray(w)))
    jq = jquant.quantize(jnp.asarray(w), 6, axis=0)
    tq = tquant.QuantizedTensor(torch.from_numpy(np.array(jq.values)),
                                torch.from_numpy(np.array(jq.scale)), 6, 0)
    np.testing.assert_array_equal(
        tl.apply_linear(torch.from_numpy(x), tq).numpy(),
        np.asarray(jl.apply_linear(jnp.asarray(x), jq)))
    jlr = jitera.itera_decompose(jnp.asarray(w), 16, 4)
    tlr = titera.LowRankQ(*(tquant.QuantizedTensor(
        torch.from_numpy(np.array(q.values)),
        torch.from_numpy(np.array(q.scale)), q.wl, q.axis)
        for q in (jlr.w1, jlr.w2)))
    np.testing.assert_array_equal(
        tl.apply_linear(torch.from_numpy(x), tlr).numpy(),
        np.asarray(jl.apply_linear(jnp.asarray(x), jlr)))


def test_embed_with_vector_positions_matches_reference():
    cfg_j = j_get_config("opus-mt", smoke=True)
    cfg_t = t_get_config("opus-mt", smoke=True)
    table = _rng(4).standard_normal((cfg_t.vocab_size, cfg_t.d_model)).astype(
        np.float32) * 0.02
    toks = _rng(5).integers(0, cfg_t.vocab_size, (3, 6)).astype(np.int32)
    pos0 = np.array([0, 17, 250], np.int32)
    _close(ttfm.embed({"embed": torch.from_numpy(table)},
                      torch.from_numpy(toks), cfg_t, torch.from_numpy(pos0)),
           jtfm.embed({"embed": jnp.asarray(table)}, jnp.asarray(toks), cfg_j,
                      pos0=jnp.asarray(pos0)))


def test_span_slots_and_block_counts_match_reference():
    rng = _rng(6)
    bs, mb = 4, 5
    table = rng.integers(1, 30, (4, mb)).astype(np.int32)
    ctx = np.array([0, 7, 13, 3], np.int32)
    ql = np.array([4, 1, 0, 6], np.int32)
    for w in (1, 8):
        bj, oj = jkv.span_slots(jnp.asarray(table), jnp.asarray(ctx),
                                jnp.asarray(ql), w, bs)
        bt, ot = tkv.span_slots(torch.from_numpy(table),
                                torch.from_numpy(ctx), torch.from_numpy(ql),
                                w, bs)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(
        tkv.valid_block_counts(torch.from_numpy(ctx), torch.from_numpy(ql),
                               bs, mb).numpy(),
        np.asarray(jkv.valid_block_counts(jnp.asarray(ctx), jnp.asarray(ql),
                                          bs, mb)))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_paged_cache_layout_and_copy_block_match_reference(kv_bits):
    cfg_j = dataclasses.replace(j_get_config("opus-mt", smoke=True),
                                kv_cache_bits=kv_bits)
    cfg_t = dataclasses.replace(t_get_config("opus-mt", smoke=True),
                                kv_cache_bits=kv_bits)
    pj = jkv.init_paged_cache(cfg_j, 6, 4)
    pt = tkv.init_paged_cache(cfg_t, 6, 4, "cpu")
    assert set(pt) == set(pj)
    rng = _rng(7)
    for key in pj:
        assert tuple(pt[key].shape) == pj[key].shape
        assert str(pt[key].dtype).split(".")[-1] == str(pj[key].dtype)
        np.testing.assert_array_equal(pt[key].numpy(), np.asarray(pj[key]))
        vals = rng.integers(-5, 5, pj[key].shape).astype(
            np.asarray(pj[key]).dtype)
        pj[key], pt[key] = jnp.asarray(vals), torch.from_numpy(vals.copy())
    pj = jkv.copy_block(pj, 2, 5)
    tkv.copy_block(pt, 2, 5)
    for key in pj:
        np.testing.assert_array_equal(pt[key].numpy(), np.asarray(pj[key]))


def test_host_allocator_and_digests_are_the_reference():
    toks = _rng(8).integers(0, 100, 23)
    assert tkv.prefix_digests(toks, 4, b"fp") == \
        jkv.prefix_digests(toks, 4, b"fp")
    for n in (0, 1, 16, 17):
        assert tkv.blocks_for_positions(n, 4) == jkv.blocks_for_positions(n, 4)
        assert tkv.blocks_needed(n + 1, 3, 4) == jkv.blocks_needed(n + 1, 3, 4)
    ops = [("alloc", 3), ("register", 0), ("free", 0), ("alloc", 5),
           ("share", 0), ("free", 1), ("alloc", 2)]
    pools = [tkv.BlockPool(9, 4), jkv.BlockPool(9, 4)]
    held = [[], []]
    digest = tkv.prefix_digests(toks, 4)
    for op, arg in ops:
        got = []
        for pool, h in zip(pools, held):
            if op == "alloc":
                h.append(pool.alloc(arg))
            elif op == "register":
                pool.register(h[arg][0], digest[0])
            elif op == "free":
                pool.free(h[arg])
            else:
                h.append([pool.share(digest[arg])])
            got.append((pool.available, pool.cached_blocks,
                        pool.evictions, h[-1]))
        assert got[0] == got[1], op

"""gemma2-9b in the port (local and global attention layers in alternation,
the {"local", "global"} decode cache, soft caps, GeGLU, tied embeddings)
against the reference on the same weights.

The smoke config (4 layers, local window 8) runs in float32 and, as the
full config's dtype, in bfloat16, from the reference's seed-0 weights,
dense or compressed by the reference, saved with its checkpoint module
and read by `repro_torch.bridge`. Prompts of 12 tokens make both prefill
(the window mask) and decode (the rolling local cache) cross the window.
Inputs are numpy-seeded; every comparison is exact unless its test states
a tolerance."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import engine as jengine
from repro.api import plan as jplan
from repro.checkpoint import ckpt as jck
from repro.configs import get_config as j_get_config
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.api import engine as tengine
from repro_torch.checkpoint import ckpt as tck
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

ARCH = "gemma2-9b"
CPU = torch.device("cpu")
DTYPES = ["float32", "bfloat16"]


def _cfgs(dtype="float32", **over):
    return (dataclasses.replace(j_get_config(ARCH, smoke=True), dtype=dtype,
                                **over),
            dataclasses.replace(t_get_config(ARCH, smoke=True), dtype=dtype,
                                **over))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{(dtype, plan): (reference params, port params, checkpoint dir)}:
    the smoke model dense, under ITERA W4 at rank fraction 0.5 and under
    quantization-only W4A8, compressed by the reference and read back
    through its checkpoint."""
    out = {}
    for dtype in DTYPES:
        cfg, _ = _cfgs(dtype)
        params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
        plans = {"dense": None,
                 "itera": jplan.CompressionPlan.uniform(
                     params, method="itera", weight_wl=4,
                     rank_fraction=0.5),
                 "quant": jplan.CompressionPlan.uniform(
                     params, method="quant", weight_wl=4)}
        for name, plan in plans.items():
            jp = jengine.InferenceEngine.build(cfg, plan, params=params).params
            path = tmp_path_factory.mktemp(f"gemma2_{dtype}_{name}")
            jck.save(str(path), 0, jp)
            out[dtype, name] = (jp, bridge.load_checkpoint(str(path)), path)
    return out


def _prompts(vocab, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_reference(smoke):
    """Every field the port keeps equals the reference's; the full
    config's parameter count is the reference's and within 12% of the
    published 9.2e9, and it is bfloat16."""
    jc, tc = j_get_config(ARCH, smoke=smoke), t_get_config(ARCH, smoke=smoke)
    want = dataclasses.asdict(jc)
    for name, value in dataclasses.asdict(tc).items():
        assert value == want[name], name
    assert tc.param_count() == jc.param_count()
    if not smoke:
        assert abs(tc.param_count() - 9.2e9) / 9.2e9 < 0.12
        assert tc.dtype == "bfloat16" and tc.local_window == 4096
        assert (tc.d_model, tc.num_heads, tc.num_kv_heads, tc.head_dim,
                tc.d_ff, tc.vocab_size) == (3584, 16, 8, 256, 14336, 256000)


# --------------------------------------------------------- checkpoints --
@pytest.mark.parametrize("dtype", DTYPES)
def test_bridge_reads_reference_checkpoint(models, dtype):
    """The reference's gemma2 checkpoint (no lm_head leaf: the head is the
    tied embedding) arrives with the same leaves, byte for byte."""
    jp, tp, path = models[dtype, "dense"]
    assert "lm_head" not in tp
    step = path / "step_00000000"
    manifest = json.loads((step / "manifest.json").read_text())
    flat_t = tck.flatten(tp)
    with np.load(step / "arrays.npz") as data:
        assert sorted(flat_t) == sorted(data.files)
        for key in data.files:
            want = data[key]
            got = flat_t[key]
            if dtype == "bfloat16":
                assert manifest["dtypes"][key] == "bfloat16"
                assert got.dtype == torch.bfloat16
                got = got.view(torch.int16)
                want = want.view(np.int16)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=key)


# ---------------------------------------------------------- transformer --
def test_window_pairs_and_cache_tree_match_reference():
    """Even layers local (window 8), odd ones global, as the reference
    pairs them; `init_cache` gives the reference's {"local", "global"}
    tree (L / 2 layers each, the local one min(window, max_len) slots)
    at both KV word lengths."""
    for kv_bits in (16, 8):
        jc, tc = _cfgs(kv_cache_bits=kv_bits)
        assert [w for _, _, w in ttfm._cache_slots(tc)] == [8, None, 8, None]
        for max_len in (6, 20):
            jcache = jtfm.init_cache(jc, 3, max_len)
            tcache = ttfm.init_cache(tc, 3, max_len)
            assert sorted(tcache) == sorted(jcache) == ["global", "local"]
            for group in jcache:
                assert {k: tuple(v.shape) for k, v in tcache[group].items()} \
                    == {k: v.shape for k, v in jcache[group].items()}


@pytest.mark.parametrize("plan", ["dense", "itera"])
def test_forward_prefill_decode_logits_match_reference(models, plan):
    """float32: `forward`'s logits over 12 positions, then prefill of the
    12-token prompt into 16 slots (the local cache rolls over 8) and
    three decode steps fed the reference's greedy tokens: logits within
    1e-4 at each, the cache tree the reference's."""
    jp, tp, _ = models["float32", plan]
    jc, tc = _cfgs()
    toks = _prompts(jc.vocab_size)
    hj, _ = jax.jit(lambda p, t: jtfm.forward(p, t, jc))(jp, jnp.asarray(toks))
    fj = jax.jit(lambda p, h: jtfm.logits_for(p, h, jc))(jp, hj)
    ht, aux = ttfm.forward(tp, torch.from_numpy(toks), tc)
    assert aux == 0.0
    np.testing.assert_allclose(ttfm.logits_for(tp, ht, tc).numpy(),
                               np.asarray(fj), rtol=0, atol=1e-4)
    lj, jcache = jax.jit(lambda p, t: jtfm.prefill(p, t, jc, max_len=16))(
        jp, jnp.asarray(toks))
    lt, tcache = ttfm.prefill(tp, torch.from_numpy(toks), tc, max_len=16)
    assert sorted(tcache) == ["global", "local"]
    for group in jcache:
        assert {k: tuple(v.shape) for k, v in tcache[group].items()} == {
            k: v.shape for k, v in jcache[group].items()}
    assert tcache["local"]["k"].shape[2] == 8
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-4)
    step = jax.jit(lambda p, c, t, pos: jtfm.decode_step(p, c, t, pos, jc))
    for pos in (12, 13, 14):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
        lj, jcache = step(jp, jcache, jnp.asarray(tok), jnp.int32(pos))
        lt, tcache = ttfm.decode_step(tp, tcache, torch.from_numpy(tok), pos,
                                      tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=1e-4, err_msg=f"pos {pos}")
        for group in jcache:
            np.testing.assert_allclose(
                tcache[group]["k"].numpy(), np.asarray(jcache[group]["k"]),
                rtol=0, atol=1e-4, err_msg=f"{group} cache, pos {pos}")


def test_loss_and_grads_match_reference(models):
    """float32, loss_chunk 4 over 12 positions: the loss within 1e-6
    relative and every leaf's gradient (the tied embedding's carries the
    head's) within 1e-5 in relative Frobenius norm."""
    jp, _, _ = models["float32", "dense"]
    jc, tc = _cfgs(loss_chunk=4)
    batch = tpipe.MarkovTask(jc.vocab_size, seed=0).batch(0, 2, 12)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(jtfm.loss_fn, has_aux=True),
                 static_argnums=2)
    (lj, _), gj = fn(jp, jb, jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jck._flatten(jp).items()}
    tp = bridge.from_flat({k: v.numpy() for k, v in tp.items()})
    (lt, _), gt = tsteps.loss_and_grads(tp, batch, tc)
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    want, got = jck._flatten(gj), tck.flatten(gt)
    assert sorted(want) == sorted(got)
    for key, a in want.items():
        err = np.linalg.norm(a - got[key].numpy()) / np.linalg.norm(a)
        assert err <= 1e-5, (key, err)


# --------------------------------------------------------------- engine --
@pytest.mark.parametrize("plan", ["itera", "quant"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_generate_matches_reference_engine(models, dtype, plan):
    """Rectangular `generate` (12-token prompts, 6 new tokens, so decode
    wraps the 8-slot local cache) gives the reference engine's greedy
    tokens, every one, at kv 16 and, for ITERA at bf16, at kv 8 (int8
    codes in both rolling and global caches)."""
    jp, tp, _ = models[dtype, plan]
    both = plan == "itera" and dtype == "bfloat16"
    for kv_bits in ((16, 8) if both else (16,)):
        jc, tc = _cfgs(dtype, kv_cache_bits=kv_bits)
        prompts = _prompts(jc.vocab_size, b=3, seed=kv_bits)
        jr = jengine.InferenceEngine(jc, jp).generate(
            prompts, jengine.SamplingParams(max_tokens=6))
        teng = tengine.InferenceEngine(tc, tp, device=CPU)
        assert not teng.bucket_prompts
        tr = teng.generate(prompts, tengine.SamplingParams(max_tokens=6))
        np.testing.assert_array_equal(np.asarray(tr.tokens),
                                      np.asarray(jr.tokens),
                                      err_msg=f"kv {kv_bits}")


def test_serve_refuses_as_the_reference_does(models):
    """The blocked KV pool takes no local/global layers, in both
    packages: `serve` raises before any step, and so does the CLI's
    --ragged."""
    jp, tp, _ = models["float32", "itera"]
    jc, tc = _cfgs()
    reqs = [p for p in _prompts(jc.vocab_size, b=2)]
    sp = jengine.SamplingParams(max_tokens=2)
    with pytest.raises(NotImplementedError, match="local/global"):
        jengine.InferenceEngine(jc, jp).serve(reqs, sp)
    with pytest.raises(NotImplementedError, match="local/global"):
        tengine.InferenceEngine(tc, tp, device=CPU).serve(
            reqs, tengine.SamplingParams(max_tokens=2))
    with pytest.raises(NotImplementedError, match="local/global"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--batch", "2", "--ragged", "--gen", "2"])


def test_serve_cli_generates_gemma2():
    """`launch.serve --arch gemma2-9b` generates rectangular (smoke, on
    the CPU) under a uniform quant W4 plan (the ITERA path's tokens are
    held to the reference's above; compressing here would only cost
    time)."""
    res = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen", "4",
                       "--compression", "quant", "--wl", "4"])
    assert res.tokens.shape == (2, 4)

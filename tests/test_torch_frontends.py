"""The modality-frontend archs in the port (chameleon-34b, vision;
musicgen-medium, audio) against the reference: their configs,
`runtime.prng.normal` (the frontend stub's embedding table is a jax
normal draw), the loss and gradients of a batch of `inputs_embeds`, and
the train CLI, which lifts each batch to embeddings as the reference's
does.

Weights are the reference's `init_params`, carried into the port with
`bridge`; data are the seeded Markov stream. Every comparison is exact
unless its test states a tolerance."""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jck
from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.checkpoint import ckpt as tck
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.runtime import prng

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

ARCHS = ["chameleon-34b", "musicgen-medium"]


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(a))


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, smoke):
    """Every field the port keeps equals the reference's (the frontend
    among them), and so does the parameter count."""
    jc, tc = j_get_config(arch, smoke=smoke), t_get_config(arch, smoke=smoke)
    want = dataclasses.asdict(jc)
    for name, value in dataclasses.asdict(tc).items():
        assert value == want[name], name
    assert tc.param_count() == jc.param_count()
    assert tc.frontend == ("vision" if arch == "chameleon-34b" else "audio")


# -------------------------------------------------------------- normal --
@pytest.mark.parametrize("seed", [0, 5])
def test_normal_matches_jax_random_normal(seed):
    """`prng.normal` against `jax.random.normal` under fold_in(PRNGKey(
    seed), 7) (the frontend table's key), 2^18 draws: bfloat16 bit for
    bit; float32 bit for bit but on at most 1e-4 of the draws, each
    within 2 ulp. Those lie at |u| > 0.997, where XLA's erf_inv takes
    sqrt(-log1p(-u^2)), and XLA's CPU square root is not correctly
    rounded (it differs from the correctly rounded one on about 0.7% of
    float32 inputs there); everything else is XLA's own float32
    arithmetic (its log1p and erf_inv polynomials, fused multiply-adds
    where it contracts them), reproduced bit for bit."""
    shape = (512, 512)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    tkey = prng.fold_in(prng.prng_key(seed), 7)
    want = np.asarray(jax.random.normal(jkey, shape, jnp.bfloat16))
    got = prng.normal(tkey, shape, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    got = prng.normal(tkey, shape).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert (ulps > 0).mean() <= 1e-4 and ulps.max() <= 2
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        prng.normal(tkey, (2,), torch.float16)


def test_frontend_table_is_the_references():
    """The train CLI's table, normal(fold_in(PRNGKey(seed), 7), (V, d),
    dtype) * 0.02, at the smoke musicgen's float32 and at bfloat16 (the
    product rounded as jax's weakly typed one): bf16 bit for bit, float32
    within 2 ulp everywhere and bit for bit but on at most 4 of its 8,192
    entries (the normal draws' rule above; measured: 1 at seed 3)."""
    for dtype in ("bfloat16", "float32"):
        tc = dataclasses.replace(t_get_config("musicgen-medium", smoke=True),
                                 dtype=dtype)
        key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
        want = np.asarray((jax.random.normal(
            key, (tc.vocab_size, tc.d_model), jnp.dtype(dtype)) * 0.02
        ).astype(jnp.float32))
        got = ttrain.frontend_table(tc, 3).float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=0)
            assert (got != want).sum() <= 4


# ---------------------------------------------------------------- loss --
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_on_embeddings_match_reference(arch):
    """`loss_and_grads` of a batch lifted to embeddings (the reference
    reads `inputs_embeds` before `tokens`): the loss within 1e-6
    relative, every leaf's gradient within 1e-5 in relative Frobenius
    norm, and the token embedding's gradient zero in both (the loss
    never reads it)."""
    jc = dataclasses.replace(j_get_config(arch, smoke=True), loss_chunk=8)
    tc = dataclasses.replace(t_get_config(arch, smoke=True), loss_chunk=8)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jc)
    batch = tpipe.MarkovTask(jc.vocab_size, seed=0).batch(0, 2, 16)
    table = ttrain.frontend_table(tc, 0)
    tb = tpipe.lift_to_embeddings(batch, table)
    jb = jpipe.lift_to_embeddings(
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
        jnp.asarray(table.numpy()))
    jb["tokens"] = jnp.zeros_like(jb["labels"])     # read, it would differ
    fn = jax.jit(jax.value_and_grad(jtfm.loss_fn, has_aux=True),
                 static_argnums=2)
    (lj, _), gj = fn(jp, jb, jc)
    (lt, _), gt = tsteps.loss_and_grads(bridge.from_flat(jck._flatten(jp)),
                                        tb, tc)
    assert _rel(lj, lt) <= 1e-6
    want, got = jck._flatten(gj), tck.flatten(gt)
    assert sorted(want) == sorted(got)
    assert not np.any(want["k:embed"]) and not torch.any(got["k:embed"])
    for key, a in want.items():
        if not np.any(a):
            continue
        err = np.linalg.norm(a - got[key].numpy()) / np.linalg.norm(a)
        assert err <= 1e-5, (key, err)


# ----------------------------------------------------------------- CLI --
@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_matches_reference_cli(arch, tmp_path):
    """The reference's CLI trains 3 steps of the smoke arch on lifted
    embeddings from its seed-0 weights; the port's CLI, on the CPU, resumes
    the reference's step-0 checkpoint and trains the same 3 steps: the
    losses within 1e-5 relative (C5; measured: at most 2e-7), and both
    end with checkpoints of the same keys."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "4",
            "--seq", "32", "--ckpt-every", "3"]
    want = jtrain.main(argv + ["--ckpt-dir", str(ref_dir)])
    port_dir.mkdir()
    shutil.copytree(ref_dir / "step_00000000", port_dir / "step_00000000")
    got = ttrain.main(argv + ["--ckpt-dir", str(port_dir), "--resume",
                              "--device", "cpu"])
    assert len(want) == len(got) == 3
    for a, b in zip(want, got):
        assert _rel(a, b) <= 1e-5
    assert tck.latest_step(str(port_dir)) == 3
    assert sorted(tck.flatten(bridge.load_checkpoint(str(ref_dir)))) == \
        sorted(tck.flatten(bridge.load_checkpoint(str(port_dir))))

"""Training the Mamba layouts in the port -- falcon-mamba-7b (layout "ssm")
and zamba2-2.7b (layout "hybrid") -- against the reference on the same
weights: the loss and every leaf's gradient through both scan engines in
float32 and bfloat16, a dense bfloat16 model beside them, two train
steps with 32- and 8-bit AdamW state, a bf16 train state's checkpoint
both ways, the chunked engine's per-chunk checkpoint and remat, softplus
at its tie, and the train CLI continuing a reference checkpoint.

The smoke configs, from the reference's seed-0 weights saved with its
checkpoint module and read by `repro_torch.bridge`; a 2 x 32 batch from a
numpy seed; the reference runs jitted.

Tolerances. float32: a leaf's largest difference within GRAD32 of its
largest gradient (measured: at most 4.7e-6). bfloat16: both packages
round every op's result to bfloat16, but their matmuls sum in other
orders, and a last-bit difference flips a bfloat16 rounding now and then
in every layer; the reference's compiled backward also rounds at other
points than autograd (ROADMAP C8). So the port's gradient is held within
GRAD_BF16 of the reference's (measured: at most 5.2%), and no farther
from the reference's float32 gradient on the same weights than
NOISE_RATIO times the reference's own bfloat16 gradient is (measured: at
most 1.5x)."""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jck
from repro.configs import get_config as j_get_config
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro.optim import adamw as jadam
from repro_torch import bridge
from repro_torch.checkpoint import ckpt as tck
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import mamba as tm
from repro_torch.optim import adamw as tadam

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

ARCHS = ["falcon-mamba-7b", "zamba2-2.7b"]
ENGINES = ["sequential", "chunked"]
DTYPES = ["float32", "bfloat16"]
B, S = 2, 32
GRAD32 = 5e-5            # float32: a leaf's largest difference / largest grad
LOSS32 = 1e-6            # float32 loss, relative
GRAD_BF16 = 0.08         # bfloat16, the same ratio
LOSS_BF16 = 1e-3         # bfloat16 loss, relative (measured: 3.2e-4)
NOISE_RATIO = 2.0        # port-to-fp32 against reference-to-fp32


def _cfgs(arch, dtype="float32", **over):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype,
                                **over),
            dataclasses.replace(t_get_config(arch, smoke=True), dtype=dtype,
                                **over))


class _Models(dict):
    """(arch, dtype) -> (reference params, a loader of the port's): the
    reference's seed-0 weights and its checkpoint of them, made at first
    use (the port's train step updates its parameters in place, so each
    test loads a fresh copy)."""

    def __init__(self, tmp_path_factory):
        super().__init__()
        self.tmp = tmp_path_factory

    def __missing__(self, key):
        arch, dtype = key
        jc, _ = _cfgs(arch, dtype)
        jp = jtfm.init_params(jax.random.PRNGKey(0), jc)
        path = str(self.tmp.mktemp(f"{arch}_{dtype}"))
        jck.save(path, 0, jp)
        self[key] = (jp, lambda: bridge.load_checkpoint(path))
        return self[key]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return _Models(tmp_path_factory)


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(
        1, vocab, (B, S + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


def _ref_grads(jp, batch, jc, engine="sequential"):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtfm.loss_fn(p, b, jc, ssm_engine=engine),
        has_aux=True))
    (loss, _), grads = fn(jp, batch)
    return float(loss), {k: np.asarray(v, np.float32)
                         for k, v in jck._flatten(grads).items()}


def _port_grads(tp, batch, tc, engine="sequential"):
    (loss, _), grads = tsteps.loss_and_grads(tp, batch, tc,
                                             ssm_engine=engine)
    return float(loss), {k: v.to(torch.float32).numpy()
                         for k, v in tck.flatten(grads).items()}


def _ratio(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _held_to_reference(models, arch, dtype, engine, noise_floor=False):
    """The port's loss and gradients against the reference's; in
    bfloat16 with `noise_floor` also against the reference's float32
    gradient on the same (bfloat16-valued) weights."""
    jc, tc = _cfgs(arch, dtype)
    jp, load = models[arch, dtype]
    jb, tb = _batch(jc.vocab_size)
    lj, gj = _ref_grads(jp, jb, jc, engine)
    lt, gt = _port_grads(load(), tb, tc, engine)
    assert sorted(gj) == sorted(gt)
    worst = {k: _ratio(gt[k], gj[k]) for k in gj}
    if dtype == "float32":
        assert abs(lt - lj) <= LOSS32 * abs(lj), (lt, lj)
        assert max(worst.values()) <= GRAD32, worst
        return
    assert abs(lt - lj) <= LOSS_BF16 * abs(lj), (lt, lj)
    assert max(worst.values()) <= GRAD_BF16, worst
    if not noise_floor:
        return
    j32 = dataclasses.replace(jc, dtype="float32")
    _, g32 = _ref_grads(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), jp), jb, j32, engine)
    ref_noise = max(_ratio(gj[k], g32[k]) for k in g32)
    port_noise = max(_ratio(gt[k], g32[k]) for k in g32)
    assert port_noise <= NOISE_RATIO * ref_noise, (port_noise, ref_noise)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_reference(models, arch, engine, dtype):
    """`loss_and_grads` through either engine against
    `jax.value_and_grad` of the reference's `loss_fn` with that engine;
    zamba2's shared block's gradient is the sum over its two uses, as
    jax's. The bfloat16 noise floor is checked on the chunked engine (the
    engines' bfloat16 gradients lie within 3e-3 of each other)."""
    _held_to_reference(models, arch, dtype, engine,
                       noise_floor=engine == "chunked")


def test_dense_bf16_loss_and_grads_match_reference(models):
    """phi3-medium-14b's bfloat16 smoke model under the same bounds: the
    bfloat16 rounding of the norms, linears and residuals is the dense
    layers' own, not the scan's."""
    _held_to_reference(models, "phi3-medium-14b", "bfloat16", "sequential",
                       noise_floor=True)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,bits", [("float32", 32), ("bfloat16", 32),
                                        ("bfloat16", 8)])
def test_train_steps_match_reference(models, arch, dtype, bits):
    """Two `make_train_step` steps through the chunked engine from the
    same weights on the same batches, each package carrying its own
    AdamW state (32- or 8-bit): losses and grad norms within 1e-5
    relative in float32; in bfloat16 the first step's within the loss
    bound and 2e-2, the second's within 1e-2 and 5e-2 (Adam's first
    update is about lr * sign(grad) for every element, so a gradient
    near zero whose sign the two packages' roundings disagree on moves
    its weight by 2 lr)."""
    jc, tc = _cfgs(arch, dtype)
    jp, load = models[arch, dtype]
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4, state_bits=bits)
    jo, to = jadam.AdamWConfig(**kw), tadam.AdamWConfig(**kw)
    jstep = jax.jit(jsteps.make_train_step(jc, jo, ssm_engine="chunked"))
    tstep = tsteps.make_train_step(tc, to, ssm_engine="chunked")
    tp = load()
    js, ts = jadam.init(jp, jo), tadam.init(tp, to)
    tols = ([(1e-5, 1e-5)] * 2 if dtype == "float32"
            else [(LOSS_BF16, 2e-2), (1e-2, 5e-2)])
    for step, (tol_loss, tol_norm) in enumerate(tols):
        jb, tb = _batch(jc.vocab_size, seed=10 + step)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tmet = tstep(tp, ts, tb)
        assert sorted(jm) == sorted(tmet)
        for k, tol in (("loss", tol_loss), ("grad_norm", tol_norm)):
            a, b = float(jm[k]), float(tmet[k])
            assert abs(a - b) <= tol * abs(a), (step, k, a, b)
        assert abs(float(jm["lr"]) - float(tmet["lr"])) <= 1e-9


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_state_checkpoint_both_ways(models, arch, tmp_path):
    """A bf16 model's train state after one step with 8-bit AdamW state
    (its float32 D, A_log and dt_bias beside bf16 weights; int8 codes and
    float32 scales), saved by each package: the same keys, shapes,
    dtypes and array dtypes; the port restores the reference's bit for
    bit and its own, and `bridge` reads the port's."""
    jc, tc = _cfgs(arch, "bfloat16")
    jp, load = models[arch, "bfloat16"]
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4, state_bits=8)
    jo, to = jadam.AdamWConfig(**kw), tadam.AdamWConfig(**kw)
    jb, tb = _batch(jc.vocab_size, seed=3)
    jp, js, _ = jax.jit(jsteps.make_train_step(jc, jo))(
        jp, jadam.init(jp, jo), jb)
    tp = load()
    tp, ts, _ = tsteps.make_train_step(tc, to)(tp, tadam.init(tp, to), tb)
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    state = {"params": tp, "opt": ts}
    tck.save(str(mine), 1, state)
    jck.save(str(theirs), 1, {"params": jp, "opt": js})
    a, b = (json.loads((d / "step_00000001" / "manifest.json").read_text())
            for d in (mine, theirs))
    for field in ("keys", "shapes", "dtypes"):
        assert a[field] == b[field], field
    assert set(a["dtypes"].values()) == {"bfloat16", "float32", "int8",
                                         "int32"}
    with np.load(theirs / "step_00000001" / "arrays.npz") as data:
        back, step = tck.restore(str(theirs), state)
        assert step == 1
        for key, t in tck.flatten(back).items():
            want = data[key]
            got = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            assert got.numpy().tobytes() == want.tobytes(), key
    flat = tck.flatten(state)
    for tree in (tck.restore(str(mine), state)[0],
                 bridge.load_checkpoint(str(mine))):
        got = tck.flatten(tree)
        assert sorted(got) == sorted(flat)
        for key, t in got.items():
            assert t.dtype == flat[key].dtype, key
            assert torch.equal(t.view(torch.int16) if t.dtype ==
                               torch.bfloat16 else t,
                               flat[key].view(torch.int16)
                               if t.dtype == torch.bfloat16 else flat[key])


class _Direct:
    """`torch.utils.checkpoint` without checkpointing: each call counted
    and run as it stands."""
    calls = 0

    @classmethod
    def checkpoint(cls, fn, *args, use_reentrant, **kwargs):
        cls.calls += 1
        return fn(*args, **kwargs)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["no chunk checkpoint", "remat full",
                                     "remat dots"])
def test_chunk_checkpoint_and_remat_change_no_bit(models, arch, variant,
                                                  monkeypatch):
    """The chunked engine over 4 chunks of 8 (`ssm.chunk` 8, S 32): its
    per-chunk checkpoint taken away, or each layer checkpointed as well
    (remat full / dots), gives the same bits of the loss and of every
    gradient; the checkpoint wraps each chunk when gradients are
    recorded, and no chunk without them."""
    _, tc = _cfgs(arch)
    tc = dataclasses.replace(tc, ssm=dataclasses.replace(tc.ssm, chunk=8))
    _, load = models[arch, "float32"]
    tp = load()
    _, tb = _batch(tc.vocab_size)
    counted = []
    real = tm.ckpt.checkpoint

    def counting(*args, **kwargs):
        counted.append(1)
        return real(*args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(tm.ckpt, "checkpoint", counting)
        (l0, _), g0 = tsteps.loss_and_grads(tp, tb, tc, ssm_engine="chunked")
    assert len(counted) >= 4 * tc.num_layers
    if variant == "no chunk checkpoint":
        _Direct.calls = 0
        monkeypatch.setattr(tm, "ckpt", _Direct)
        (l1, _), g1 = tsteps.loss_and_grads(tp, tb, tc, ssm_engine="chunked")
        assert _Direct.calls == 4 * tc.num_layers
        with torch.no_grad():
            _Direct.calls = 0
            tsteps.make_prefill_step(tc, ssm_engine="chunked")(tp, tb)
        assert _Direct.calls == 0
    else:
        on = dataclasses.replace(tc, remat=True,
                                 remat_policy=variant.split()[1])
        (l1, _), g1 = tsteps.loss_and_grads(tp, tb, on, ssm_engine="chunked")
    assert torch.equal(l0, l1)
    a, b = tck.flatten(g0), tck.flatten(g1)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_softplus_gradient_at_the_tie():
    """`_softplus` gives `jax.nn.softplus`'s gradient, 0.5 at x = 0 (where
    `clamp_min` would give 1), and max(x, 0)'s bits elsewhere."""
    x = torch.tensor([0.0, -0.0, 1e-30, -3.0, 2.5, 40.0, -40.0],
                     requires_grad=True)
    tm._softplus(x).sum().backward()
    want = jax.grad(lambda v: jax.nn.softplus(v).sum())(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6)
    assert float(x.grad[0]) == float(x.grad[1]) == 0.5
    t = torch.randn(4096) * 30
    e = tm._exp_f32(-t.abs())
    old = torch.clamp_min(t, 0.0) + torch.log1p(e.to(torch.float64)).to(
        torch.float32)
    assert torch.equal(tm._softplus(t), old)


def _cli_args(arch, ckpt_dir, steps):
    return ["--arch", arch, "--smoke", "--steps", str(steps), "--batch",
            "4", "--seq", "32", "--ckpt-dir", str(ckpt_dir), "--ckpt-every",
            "3"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_continues_a_reference_checkpoint(arch, tmp_path):
    """The reference's CLI trains 6 steps (checkpoints at 0, 3 and 6);
    the port's CLI resumes its step-0 checkpoint on the CPU for the same
    6 steps with a failure injected at step 4, restored from the step-3
    checkpoint it wrote: its 7 losses (step 3 twice) within 1e-5 relative
    of the reference's, and both write the same checkpoint keys."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    want = jtrain.main(_cli_args(arch, ref_dir, 6))
    port_dir.mkdir()
    shutil.copytree(ref_dir / "step_00000000", port_dir / "step_00000000")
    got = ttrain.main(_cli_args(arch, port_dir, 6) + [
        "--resume", "--device", "cpu", "--inject-failure-at", "4"])
    want = list(want[:4]) + list(want[3:])
    assert len(got) == len(want) == 7
    for a, b in zip(want, got):
        assert abs(a - b) <= 1e-5 * abs(a), (want, got)
    assert tck.latest_step(str(port_dir)) == 6
    ja = bridge.load_checkpoint(str(ref_dir))
    tb = bridge.load_checkpoint(str(port_dir))
    assert sorted(tck.flatten(ja)) == sorted(tck.flatten(tb))


def leaf_report(arch, dtype="bfloat16", engine="chunked"):
    """Print, leaf by leaf, the port's largest difference from the
    reference's gradient and both packages' from the reference's float32
    gradient on the same weights (each over that leaf's largest |grad|),
    the figures the bounds above are set from."""
    import tempfile

    models = _Models(type("T", (), {"mktemp": staticmethod(
        lambda name: tempfile.mkdtemp(prefix=name))}))
    jc, tc = _cfgs(arch, dtype)
    jp, load = models[arch, dtype]
    jb, tb = _batch(jc.vocab_size)
    lj, gj = _ref_grads(jp, jb, jc, engine)
    lt, gt = _port_grads(load(), tb, tc, engine)
    _, g32 = _ref_grads(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32), jp), jb,
        dataclasses.replace(jc, dtype="float32"), engine)
    print(f"{arch} {dtype} {engine}: loss {lt:.6f} (port) / {lj:.6f} "
          f"(reference), relative {abs(lt - lj) / abs(lj):.2e}")
    print(f"  {'leaf':44s} port-ref  ref-fp32  port-fp32")
    for k in sorted(gj):
        print(f"  {k:44s} {_ratio(gt[k], gj[k]):.2e}  "
              f"{_ratio(gj[k], g32[k]):.2e}  {_ratio(gt[k], g32[k]):.2e}")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_mamba_train.py
    for name in ARCHS:
        for eng in ENGINES:
            leaf_report(name, "float32", eng)
            leaf_report(name, "bfloat16", eng)
    leaf_report("phi3-medium-14b")

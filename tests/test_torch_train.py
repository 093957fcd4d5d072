"""The port's training path against the reference's on the CPU: AdamW
(schedules, 32-bit and 8-bit state), the chunked loss and its gradients,
activation checkpointing, the train step with and without gradient
accumulation, `hash_batch`, the frontend stub, the prefetcher,
`ResilientLoop`, and the train CLI resuming a reference checkpoint.

Weights are the reference's `init_params`, carried into the port with
`bridge.from_flat`; data are the seeded Markov and hash streams. The port
takes the norms, GELU and attention in float64 where the reference takes
them in float32, so float results agree within the tolerances each test
states, not bit for bit."""
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
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro.optim import adamw as jadam
from repro.runtime import fault as jfault
from repro_torch import bridge
from repro_torch.checkpoint import ckpt as tck
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadam
from repro_torch.runtime import fault as tfault

# One intra-op thread: the suite runs in several processes at once, and
# full OpenMP teams there wait on each other (the port's tests in 6
# processes: 689 s with 8 threads each, 151 s with 1).
torch.set_num_threads(1)

B, S = 4, 32


def _configs(**over):
    jc = j_get_config("opus-mt", smoke=True)
    tc = t_get_config("opus-mt", smoke=True)
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


def _to_port(tree):
    return bridge.from_flat(jck._flatten(tree))


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref_params():
    jc, _ = _configs()
    return jtfm.init_params(jax.random.PRNGKey(0), jc)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(a))


# ----------------------------------------------------------------- adamw --
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    """Steps 0, 1, the end of warmup, mid-decay, the last step and beyond:
    within 1 ulp of the reference's float32 learning rate."""
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=50, schedule=schedule)
    jcfg, tcfg = jadam.AdamWConfig(**kw), tadam.AdamWConfig(**kw)
    for step in (0, 1, 10, 27, 50, 80):
        a = np.float32(jadam.schedule_lr(jcfg, jnp.asarray(step, jnp.int32)))
        b = np.float32(tadam.schedule_lr(tcfg, torch.tensor(step,
                                                           dtype=torch.int32)))
        assert abs(a - b) <= np.spacing(a), (step, a, b)


def _grad_tree(rng, params, scale):
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                              * scale), params)


def test_update_32bit_matches_reference(ref_params):
    """Three updates (a clipped and two unclipped gradients) from the
    same state: params, m and v within 1e-6 of each leaf's largest
    magnitude (element-wise relative error is meaningless where
    p - lr * upd cancels), grad_norm and lr within 1e-6 relative."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg, tcfg = jadam.AdamWConfig(**kw), tadam.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    jp, js = ref_params, jadam.init(ref_params, jcfg)
    for scale in (3.0, 0.01, 0.02):
        g = _grad_tree(rng, jp, scale)
        tp, ts = _to_port(jp), _to_port(js)
        jp, js, jm = jadam.update(g, js, jp, jcfg)
        tp, ts, tm = tadam.update(_to_port(g), ts, tp, tcfg)
        for k in ("grad_norm", "lr"):
            assert _rel(jm[k], tm[k]) <= 1e-6, k
        want, got = jck._flatten({"p": jp, "s": js}), tck.flatten(
            {"p": tp, "s": ts})
        assert sorted(want) == sorted(got)
        for key, a in want.items():
            b = got[key].numpy()
            assert b.dtype == a.dtype, key
            tol = 1e-6 * max(float(np.max(np.abs(a))), 1e-30)
            assert float(np.max(np.abs(a.astype(np.float64) - b))) <= tol, key


def test_update_8bit_codes_match_reference(ref_params):
    """The 8-bit state after each of three updates from the same inputs:
    the int8 codes of m and v within one step of the reference's, at no
    more than 1 in 10,000 of them, and the scales and offsets within 1e-6
    relative. Their scales follow from taking `absmax / 127` and
    `(hi - lo) / 254` as products with the float32 reciprocal, as jit
    does (a true division gives other scales). The exceptions: XLA's CPU
    compiler contracts the moments' `b * m + (1 - b) * g` into a fused
    multiply-add, where torch rounds each product, so a moment differs
    from the reference's in its last bit at some elements, and a code on a
    rounding boundary moves by one (measured: 0, 2 and 2 of 330,752 codes
    at the three updates, one of m and one of v each time)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, state_bits=8)
    jcfg, tcfg = jadam.AdamWConfig(**kw), tadam.AdamWConfig(**kw)
    rng = np.random.default_rng(1)
    jp, js = ref_params, jadam.init(ref_params, jcfg)
    for scale in (3.0, 0.01, 0.02):
        g = _grad_tree(rng, jp, scale)
        tp, ts = _to_port(jp), _to_port(js)
        jp, js, _ = jadam.update(g, js, jp, jcfg)
        _, ts, _ = tadam.update(_to_port(g), ts, tp, tcfg)
        want, got = jck._flatten(js), tck.flatten(ts)
        assert sorted(want) == sorted(got)
        flips = codes = 0
        for key, a in want.items():
            b = got[key].numpy()
            assert b.dtype == a.dtype, key
            if a.dtype == np.int8:
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d.max() <= 1, key
                flips += int((d > 0).sum())
                codes += d.size
            else:
                np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        assert flips <= codes // 10_000, (flips, codes)


# ------------------------------------------------------------------ loss --
def _loss_and_grads_ref(jp, batch, jc):
    fn = jax.jit(jax.value_and_grad(jtfm.loss_fn, has_aux=True),
                 static_argnums=2)
    return fn(jp, batch, jc)


def test_loss_fn_and_grads_match_reference(ref_params):
    """loss_chunk 8 over seq 32 (four chunks): the loss and ce within
    1e-6 relative, aux 0.0, and every leaf's gradient within 1e-5 in
    relative Frobenius norm (measured: at most 7.1e-7)."""
    jc, tc = _configs(loss_chunk=8)
    batch = tpipe.MarkovTask(jc.vocab_size, seed=0).batch(0, B, S)
    (lj, mj), gj = _loss_and_grads_ref(ref_params, _jbatch(batch), jc)
    (lt, mt), gt = tsteps.loss_and_grads(_to_port(ref_params), batch, tc)
    assert _rel(lj, lt) <= 1e-6 and _rel(mj["ce"], mt["ce"]) <= 1e-6
    assert float(mj["aux"]) == mt["aux"] == 0.0
    want, got = jck._flatten(gj), tck.flatten(gt)
    assert sorted(want) == sorted(got)
    for key, a in want.items():
        err = np.linalg.norm(a - got[key].numpy()) / np.linalg.norm(a)
        assert err <= 1e-5, (key, err)


def test_chunked_loss_equals_one_chunk(ref_params):
    """The chunks' sum is the whole sequence's: loss_chunk 8, 5 (the
    largest divisor of 32 below it, 4) and 2048 (one chunk) agree within
    1e-6 relative; without gradients no chunk is checkpointed."""
    batch = tpipe.MarkovTask(512, seed=3).batch(1, B, S)
    losses = []
    for chunk in (8, 5, 2048):
        _, tc = _configs(loss_chunk=chunk)
        with torch.no_grad():
            loss, _ = ttfm.loss_fn(_to_port(ref_params), batch, tc)
        losses.append(float(loss))
    assert max(losses) - min(losses) <= 1e-6 * losses[0]


def test_loss_on_embeddings_matches_reference(ref_params):
    """`lift_to_embeddings` (the frontend stub): the same table and
    tokens through both packages' loss_fn, within 1e-6 relative."""
    jc, tc = _configs()
    batch = tpipe.MarkovTask(jc.vocab_size, seed=0).batch(2, B, S)
    table = np.random.default_rng(2).standard_normal(
        (jc.vocab_size, jc.d_model)).astype(np.float32) * 0.02
    jb = jpipe.lift_to_embeddings(_jbatch(batch), jnp.asarray(table))
    tb = tpipe.lift_to_embeddings(batch, torch.from_numpy(table))
    assert np.array_equal(np.asarray(jb["inputs_embeds"]),
                          tb["inputs_embeds"].numpy())
    lj, _ = jtfm.loss_fn(ref_params, jb, jc)
    with torch.no_grad():
        lt, _ = ttfm.loss_fn(_to_port(ref_params), tb, tc)
    assert _rel(lj, lt) <= 1e-6


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_identical_loss_and_grads(ref_params, policy):
    """Activation checkpointing ("full": the layer recomputed; "dots":
    its matmul outputs kept) changes no bit of the loss or gradients."""
    _, off = _configs(remat=False)
    _, on = _configs(remat=True, remat_policy=policy)
    batch = tpipe.MarkovTask(512, seed=0).batch(0, B, S)
    tp = _to_port(ref_params)
    (l0, _), g0 = tsteps.loss_and_grads(tp, batch, off)
    (l1, _), g1 = tsteps.loss_and_grads(tp, batch, on)
    assert torch.equal(l0, l1)
    a, b = tck.flatten(g0), tck.flatten(g1)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_remat_rejects_an_unknown_policy(ref_params):
    _, tc = _configs(remat=True, remat_policy="everything")
    batch = tpipe.MarkovTask(512, seed=0).batch(0, B, S)
    with pytest.raises(ValueError, match="remat_policy"):
        tsteps.loss_and_grads(_to_port(ref_params), batch, tc)


# ------------------------------------------------------------ train step --
@pytest.mark.parametrize("bits,microbatches", [(32, 1), (32, 2), (8, 1)])
def test_train_step_matches_reference(ref_params, bits, microbatches):
    """Five steps from the same weights on the same Markov batches, each
    package carrying its own state: the losses and grad norms within
    1e-6 relative with 32-bit state (measured: at most 1.5e-7) and
    within 1e-5 with 8-bit state (measured: 7.3e-7 at step 5). The
    reference's step is `make_train_step` (one microbatch) or
    `make_accum_train_step`, jitted, as its CLI runs them."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, state_bits=bits)
    jo, to = jadam.AdamWConfig(**kw), tadam.AdamWConfig(**kw)
    jc, tc = _configs()
    if microbatches == 1:
        jstep = jax.jit(jsteps.make_train_step(jc, jo))
        tstep = tsteps.make_train_step(tc, to)
    else:
        jstep = jax.jit(jtrain.make_accum_train_step(jc, jo, microbatches))
        tstep = ttrain.make_accum_train_step(tc, to, microbatches)
    tol = 1e-6 if bits == 32 else 1e-5
    task = tpipe.MarkovTask(jc.vocab_size, seed=0)
    jp, tp = ref_params, _to_port(ref_params)
    js, ts = jadam.init(jp, jo), tadam.init(tp, to)
    for step in range(5):
        batch = task.batch(step, B, S)
        jp, js, jm = jstep(jp, js, _jbatch(batch))
        tp, ts, tm = tstep(tp, ts, batch)
        assert sorted(jm) == sorted(tm)
        for k in ("loss", "grad_norm"):
            assert _rel(jm[k], tm[k]) <= tol, (step, k)
        assert abs(float(jm["lr"]) - float(tm["lr"])) <= 1e-6 * kw["lr"]


def test_train_step_updates_params_in_place(ref_params):
    """The step writes the new parameters into the tensors it was given
    and returns them."""
    _, tc = _configs()
    tp = _to_port(ref_params)
    before = tp["lm_head"].clone()
    to = tadam.AdamWConfig(lr=1e-2, warmup_steps=1)
    step = tsteps.make_train_step(tc, to)
    out, _, _ = step(tp, tadam.init(tp, to),
                     tpipe.MarkovTask(512).batch(0, B, S))
    assert out["lm_head"] is tp["lm_head"]
    assert not torch.equal(tp["lm_head"], before)


# ------------------------------------------------------------------ data --
@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (0, 0, 2, 8, 100), (3, 17, 4, 33, 32000), (0, 5, 8, 128, 32000),
    (7, 1, 1, 1, 2), (1, 2, 3, 5, 512)])
def test_hash_batch_is_bit_equal(seed, step, batch, seq, vocab):
    a = jpipe.hash_batch(seed, step, batch, seq, vocab)
    b = tpipe.hash_batch(seed, step, batch, seq, vocab)
    for k in ("tokens", "labels"):
        assert b[k].dtype == torch.int32
        assert np.array_equal(np.asarray(a[k]), b[k].numpy())


def test_prefetcher_yields_steps_in_order():
    task = tpipe.MarkovTask(64, seed=1)
    pf = tpipe.Prefetcher(lambda s: task.batch(s, 2, 4), start_step=3)
    try:
        got = [next(pf) for _ in range(4)]
    finally:
        pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for s, b in got:
        assert torch.equal(b["tokens"], task.batch(s, 2, 4)["tokens"])
    pf._t.join(timeout=5)
    assert not pf._t.is_alive()


# --------------------------------------------------------- resilient loop --
class _StepClock:
    """A deterministic `time.monotonic`: it reads `t`, which only a step
    moves, by 1.0 s or by `slow` s for the steps in `slow_steps`. So each
    step times the same in both loops and no wall-clock hiccup flags a
    straggler in one loop and not in the other."""

    def __init__(self, slow_steps=(), slow=10.0):
        self.t, self.slow_steps, self.slow = 0.0, set(slow_steps), slow

    def __call__(self) -> float:
        return self.t

    def tick(self, step: int) -> None:
        self.t += self.slow if step in self.slow_steps else 1.0


def _run_loop(mod, monkeypatch, *, inject, fail_from=None, max_failures=3,
              slow_steps=()):
    """A deterministic loop: the state counts steps, the loss is a
    function of the step, saves every 3 steps into a dict; each step
    takes 1 s of `_StepClock` time, `slow_steps` 10 s."""
    saved = {0: 0}
    clock = _StepClock(slow_steps)
    monkeypatch.setattr(mod.time, "monotonic", clock)
    remeshes = []

    def step_fn(state, step):
        clock.tick(step)
        if fail_from is not None and step >= fail_from:
            raise ValueError(f"step {step} fails")
        return state + 1, {"loss": 0.5 * step}

    def save_fn(state, step):
        saved[step] = state

    def restore_fn():
        step = max(saved)
        return saved[step], step

    loop = mod.ResilientLoop(step_fn, save_fn, restore_fn, ckpt_every=3,
                             max_failures=max_failures,
                             inject_failure_at=inject,
                             on_straggler=lambda: remeshes.append(clock.t))
    try:
        out = loop.run(0, 0, 10)
    except RuntimeError as e:
        out = str(e)
    return out, dataclasses.asdict(loop.report), remeshes


@pytest.mark.parametrize("case", ["injected", "failures run out", "clean",
                                  "stragglers"])
def test_resilient_loop_report_matches_reference(case, monkeypatch):
    """The whole report, straggler events included, on the step clock;
    "stragglers" makes steps 4-6 and 8 slow: three in a row call
    `on_straggler` once (patience 3), and step 8 is one more event."""
    kw = {"injected": dict(inject=7),
          "failures run out": dict(inject=None, fail_from=5,
                                   max_failures=2),
          "clean": dict(inject=None),
          "stragglers": dict(inject=None, slow_steps=(4, 5, 6, 8))}[case]
    got = _run_loop(tfault, monkeypatch, **kw)
    assert got == _run_loop(jfault, monkeypatch, **kw)
    report = got[1]
    if case == "stragglers":
        assert report["straggler_events"] == 4
        assert report["remesh_events"] == 1 and len(got[2]) == 1
    else:
        assert report["straggler_events"] == 0 and not got[2]


# ------------------------------------------------------------------- CLI --
def _cli_args(ckpt_dir, steps):
    return ["--arch", "opus-mt", "--smoke", "--steps", str(steps), "--batch",
            "4", "--seq", "32", "--ckpt-dir", str(ckpt_dir), "--ckpt-every",
            "3"]


def test_train_cli_continues_a_reference_checkpoint(tmp_path):
    """The reference's CLI trains 3 steps and checkpoints; the port's CLI
    resumes it on the CPU to step 6, as the reference's does on a copy:
    the losses of steps 3-5 within 1e-5 relative (measured: at most
    2e-7), and both write the same checkpoint keys."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jtrain.main(_cli_args(ref_dir, 3))
    shutil.copytree(ref_dir, port_dir)
    want = jtrain.main(_cli_args(ref_dir, 6) + ["--resume"])
    got = ttrain.main(_cli_args(port_dir, 6) + ["--resume", "--device",
                                                "cpu"])
    assert len(want) == len(got) == 3
    for a, b in zip(want, got):
        assert _rel(a, b) <= 1e-5
    assert tck.latest_step(str(port_dir)) == 6
    ja = bridge.load_checkpoint(str(ref_dir))
    tb = bridge.load_checkpoint(str(port_dir))
    assert sorted(tck.flatten(ja)) == sorted(tck.flatten(tb))


def test_train_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(_cli_args(tmp_path, 1))


def test_train_cli_refuses_a_mesh(tmp_path):
    with pytest.raises(NotImplementedError, match="A6"):
        ttrain.main(_cli_args(tmp_path, 1) + ["--mesh", "2x1", "--device",
                                              "cpu"])


def test_train_cli_hash_data_with_accumulation_and_8bit_state(tmp_path):
    """The CLI's other options on the CPU: hash data, 2 microbatches, the
    8-bit state, and an injected failure replayed from a checkpoint."""
    losses = ttrain.main(_cli_args(tmp_path, 6) + [
        "--device", "cpu", "--data", "hash", "--microbatches", "2",
        "--opt-bits", "8", "--inject-failure-at", "4"])
    assert len(losses) == 6 + 1         # step 3 replayed from its save
    assert np.all(np.isfinite(losses))
    assert losses[3] == losses[4]
    _, step = tck.restore(str(tmp_path), {"opt": {
        "count": torch.zeros((), dtype=torch.int32)}})
    assert step == 6

#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port of ITERA-LLM on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port (`src/repro_torch`; nothing of jax or of the JAX package)
through these phases, and exits non-zero, printing no result, if any
fails:

1. build: compile every CUDA kernel from `src/repro_torch/kernels/csrc`
   (one nvcc per source, all started together; phase 2 checks each
   integer kernel as soon as its own library is built);
2. kernels: each kernel against its plain PyTorch version at the serving
   path's shapes -- the integer kernels bit-equal, paged attention within
   1e-5, also with key splits that end mid-block; with the speculative
   path's shapes: the draft's truncated cascades (R 128, 160, 192, and
   A6), the verify pass's (M 64 at R 256, the lm head at M 48, attention
   spans of 1-5 tokens in a W 8 bucket); with the compression phase's:
   unpacked W8 factors at R 192, 256, 320 and 384 for every linear and
   the lm head as a cascade at decode (M 8) and in the calibration
   forward (M 2048), and the svd plan's verify pass (M 64, the lm head
   at M 48); with the rectangular phase's prefill (M 1024, both plans'
   layer linears); with the dse phase's batch of 512 rows; with the moe
   phase's shapes (the W8 lm head K 2048 -> N 102,400; R 1024 cascades at
   M 8, 32 and 2048; attention at Dh 128, 16 heads, decode and a W 256
   prefill) -- timed beside
   its plain version, a PyTorch library yardstick and the least time the
   card could take (its bound), with a warning line wherever the kernel
   is slower than its plain version; each linear launch also replayed
   back to back in a CUDA graph, and, at the dse phase's batches, its
   layer timed through `ops` (the activations' quantization included; a
   low-rank layer on the cascade and on the single engine); the single
   engine, `ops.lrmm(fused=False)`, must give the plain version's bits
   too. Compared bit for bit but not timed (their times are PERF.md's):
   both kernels over deepseek-moe-16b's E 64 expert stacks at capacities
   1, 30 and 240, one launch a projection; lowrank_qmm past R 1024 (R
   1056, 4096, 4128 -- the smallest on the grouped path, T through device
   memory -- 9216, and an E 8 stack at R 1280) at M 8 and 2048 with an
   fp32 and a bf16 Y, and the bf16, gemma2 and nemotron phases' served
   ranks with an fp32 Y.
   Every later path checks that each of its lowrank_qmm launches took a
   code path (tile rows, K, R, N, packing) that this phase compared;
3. engine: opus-mt at full width, compressed by the port with a mixed plan
   (ITERA W4A8 at rank fraction 0.5 for every attention and MLP linear,
   W8A8 quantization for the lm head), serving 16 ragged requests with an
   fp32 KV pool and again with int8 KV; every kernel's launch counter,
   zeroed just before, must be > 0 after; then the paper's quantization-
   only baseline (W4A8 for every attention and MLP linear, the same W8A8
   lm head) serving the same requests with an fp32 pool, every linear on
   `quant_matmul`; the two plans' serves side by side (A B B A) with the
   host time of a linear call under each, then each serve once more
   under torch.profiler;
   sampling: the mixed plan serving the 16 requests sampled (temperature
   0.8, top-k 50, top-p 0.9, seed 7; four at temperature 0, which must
   give phase 3's tokens), again (identical), with the prefix cache off
   (identical), and with eos ids and stop sequences on four requests
   (each output `match_stop_host` of its untruncated run, and streamed
   alike through on_token);
   speculation: the mixed plan with DraftSpec(k=4, rank_fraction=0.5),
   greedy, fp32 and int8 KV: phase 3's tokens, with the draft's R 128
   cascades launched 4 x 72 times a drafting round; plain and speculative
   serves timed A B B A; then the served model as its own draft (rank
   fraction 1.0), which accepts its drafts: phase 3's tokens again;
   compression: weights from seed 0 shaped to s_i ~ i^-2
   (`shape_spectra`); the paper's SVD-then-quantize baseline as fig13
   serves it (W8A8 at rank fraction 0.75 for every linear, the lm head
   included: R 384) compressed on the card, with each leaf's error and
   ITERA W4 against SVD W4 at the same rank (ITERA's must be no larger);
   served greedy (73 lowrank_qmm launches a step, all at R 384, 12 of
   paged_attention, none of quant_matmul) and speculatively with a rank
   0.5 draft (the plain serve's tokens); SRA over the calibration forward
   (greedy agreement with the uncompressed model on 2 x 8 x 256 tokens,
   half the summed maximum ranks, at most 2 iterations; its launches by
   rank checked against the allocations it evaluated) and a greedy serve
   of its allocation, and of its last move when it kept equal ranks,
   with each plan's launches a step by rank checked;
   dse: the paper's hardware-aware design space exploration on the
   compression phase's shaped weights: seven candidate plans (quant-only
   and ITERA at W8 / W6 / W4, ITERA W4 also at rank fraction 0.375, each
   with a W8A8 lm head) compressed on the card and scored by calibration
   agreement; `co_design(platform="h100")` at batch_m 8 and 512, each
   front printed; every distinct launch of the candidates beside the H100
   model's prediction, read from phase 2's rows (the graph replay the
   yardstick, the timer beside it), its priced partition the one the
   wrapper launches and the shared-memory mirrors equal to the
   libraries'; LAUNCH_S, the rank correlation of predicted and measured
   linear latency and fig11's ITERA-vs-quant reduction; each front's
   best and fastest point and the ITERA front's best sent through
   from_design_point -> JSON -> InferenceEngine.build and served
   captured, launches by kernel, rank and (K, N) checked;
   rectangular: `InferenceEngine.generate` on 8 Markov-task prompts of
   128 tokens, 32 tokens a row: one prefill (every layer linear at M
   1024, the lm head at the last position only), then lockstep decode
   steps over a contiguous KV cache. The mixed plan, fp32 and int8 KV:
   launches exactly 72 lowrank_qmm and 1 quant_matmul a pass, no paged
   attention, the tokens `serve` gives the same prompts, the prompts cut
   to 100 tokens (bucket 128) as an unbucketed engine gives them; the
   quant-only plan: 73 quant_matmul launches a pass by (K, N); sampled
   (seed 7) twice and against serve; a sampled stop run against
   `match_stop_host`;
   train: opus-mt full() trained on the card from seed-0 weights
   (LatentMarkovTask, batch 8 x seq 128, AdamW with warmup and cosine
   decay, remat "full") through launch/train.py's step in a
   ResilientLoop with checkpoints and an injected failure: finite losses,
   a lower last ten than first ten, the replayed steps within 1e-5 of the
   first pass; step ms, tokens/s and peak bytes beside the FLOP bound, and
   20 steps each with remat full, dots and off, 8 each at a training-size
   batch of 32 x 512; the train CLI (launch/train.py's `main`) on its
   default device with 2 microbatches of hash data, an injected failure
   and --resume, its losses within 1e-5 of the step's own; 3 steps on the
   card and on the CPU within 1e-4 (loss and grad norm); the trained
   state through ckpt.save / ckpt.restore / bridge.load_checkpoint,
   equal; the trained weights compressed under both phase-3 plans, serving 16 task prompts
   captured (launches by kernel and (K, N), every lowrank_qmm launch on a
   compared path) and 4 short ones card == CPU; the held-out greedy
   accuracy of the dense and both compressed models and the speculation
   draft's accept rate on the trained mixed plan (its tokens the plain
   serve's);
   graphs: every step above (and below) is the replay of a CUDA graph
   captured per step shape, the engines' default; here the mixed plan
   (fp32 and int8 KV) and the quant-only plan each run greedy, sampled,
   stopped and speculative (DraftSpec(k=4, rank_fraction=0.5)) serves of
   8 of the requests and greedy and sampled generates of the 8
   Markov-task prompts, 16 tokens each, both captured and eagerly
   (`cuda_graphs=False`): identical tokens and launch counters, each
   case's seconds; the graphs held, their capture seconds and
   the memory they reserved; then one eager and one captured round of
   serve (TPOT p50, TTFT p50, tok/s) and generate (prefill ms, decode ms
   a step, tok/s) of the mixed kv16 plan (GRAPH_ROUNDS rounds: median,
   min and max), and one serve and one generate of each under
   torch.profiler;
   tp: tensor-parallel serving (`launch.mesh`, `launch.sharding`) of
   opus-mt at full width. tp 1 over NCCL in this process, captured: the
   mixed plan at fp32 and int8 KV serving the graphs phase's 8 requests,
   16 tokens, with the solo captured engine's tokens and launches, the
   step graphs captured, TPOT p50 A B B A beside the solo engine's and
   the NCCL kernels a step under torch.profiler (a one-rank NCCL
   all-reduce launches none: these graphs hold no real collective, and
   capturing one is not verified here); `all_reduce` called while the
   step graphs were captured, and an eager tp 1 engine over the same
   NCCL group calling it exactly 2L times a step with the solo tokens.
   tp 2 over gloo, two rank
   processes sharing the card, eagerly (gloo reduces CUDA tensors through
   the host, which a CUDA graph cannot capture; NCCL refuses two ranks on
   one card): the mixed plan's compressed weights at kv 16 and 8 on 4
   short requests == the same weights at tp 2 on the CPU, and so does a
   bf16 quant-only engine (compressed in each rank; its tokens against
   the solo engine's are printed, not gated: a compressed K-site
   requantizes its activations over each rank's features, as the
   reference's); a dense fp32 engine == the solo card engine on the 8
   requests; the svd W8 r0.75 plan on the
   N-sites with speculation (DraftSpec(k=4, rank_fraction=0.25)) == the
   plain solo engine, drafts made; every lowrank_qmm and quant_matmul
   launch at a key phase 2 compared (its per-rank shapes: K 512 -> N 256
   / 1024 and K 256 / 1024 -> N 512, every row count a step takes,
   bit-equal, untimed; attention at 4 heads of 64); the ranks' step
   times printed, which are not a TP speed; the CPU's tp 2 ranks run
   while the card's do;
4. parity: the compressed weights of the phase-3 plans, of the svd plan
   and of the SRA plans (each compressed once on the card), copied to the
   CPU, and the dse phase's deployed plans, serve 4 short requests there
   (the kernels' plain versions) and on the card; the greedy tokens must be identical, and so must the mixed
   plan's seeded sampled and speculative tokens; the phase-3 plans also
   generate from 4 prompts of 29 tokens (bucket 32) on both, greedy at
   kv 16 and 8 and, for the mixed plan, sampled: identical tokens;
5. moe: deepseek-moe-16b at its published widths (d_model 2048, 16 heads
   of 128, 64 routed experts of d_ff 1408 top-6 at capacity factor 1.25,
   2 shared, vocab 102,400), 1 of its 28 layers, fp32, seed-0 random
   weights, compressed on the card under the mixed and the quant-only
   plan (the router kept float; ITERA at 4 power iterations a rank-1
   step, one expert stack's error printed at 4 and at the default 24);
   8 requests of 32-256 prompt tokens, 16
   new, served captured (greedy fp32 and int8 KV, sampled) and eagerly:
   every step launches exactly 10 lowrank_qmm + 1 quant_matmul + 1
   paged_attention (mixed) or 11 quant_matmul + 1 paged_attention
   (quant-only), one launch for each projection of all 64 experts;
   captured == eager tokens and counters; the copies routed and dropped
   by step kind; a profile of each serve; generate of 8 x 128 prompts
   timed with exact launches; card == CPU for 4 short requests greedy
   and sampled and for a 4 x 29 generate, under both plans;
6. bf16: the bfloat16 model dtype. phi3-medium-14b at its published
   widths (d_model 5120, 40 heads of 128 over 10 KV heads, SwiGLU d_ff
   17920, RMSNorm, RoPE, vocab 100,352), bfloat16, 1 of its 40 layers,
   seed-0 random weights, compressed on the card under the mixed plan at
   the reference's default rank fraction 0.5 (ITERA W4A8, R 2560 and 640,
   at 4 power iterations a rank-1 step; W8A8 lm head) and quant-only
   W4A8; 8 requests of 32-256 prompt tokens, 16 new, served captured
   (greedy with a bf16 and an int8 pool; the mixed plan also sampled) and
   eagerly: every step launches exactly 7 lowrank_qmm + 1 quant_matmul +
   1 paged_attention (mixed) or 8 quant_matmul + 1 paged_attention
   (quant-only), the linears writing bf16 from their epilogues; captured
   == eager tokens;
   a profile of each phi3 serve; then stablelm-12b (32 heads of 160 over 8, LayerNorm, 25% rotary),
   bfloat16, 1 of 40 layers, quant-only, greedy at both pools; card ==
   CPU for 4 short requests on every one of those paths. Phase 2
   compares these models' launch shapes first, untimed: both integer
   kernels with a bf16 output at every row count a step takes
   (bit-equal), and bf16 attention at Dh 128, 160 and 192 over a bf16 and an int8 pool
   (within one bf16 ulp on at most 1e-4 of the outputs);
7. gemma2: gemma2-9b at its published widths (d_model 3584, 16 heads of
   256 over 8 KV heads, GeGLU d_ff 14336, vocab 256,000, tied embeddings,
   soft caps 50 / 30), bfloat16, 2 of its 42 layers -- one local/global
   pair, the local layer's window 4096 -- seed-0 random weights,
   compressed on the card under ITERA W4A8 r0.5 (R 1792 and 1024) and
   quant-only W4A8, the tied head a dense bf16 product; `generate` of 8 x
   128 prompts, 16 new tokens, captured and eagerly (the mixed plan also
   sampled), launches exactly 14 of the plan's kernel a pass, captured ==
   eager tokens, prefill and decode times; card == CPU on 4 x 32 prompts,
   8 new, under both plans; and a 4,100-token prompt with 24 new tokens
   (the prefill's window mask and the rolling local cache's wrap) held to
   the card's own teacher-forced `forward`: its argmax at every position
   but where its top two logits lie within 0.1 (at most one);
8. mamba: falcon-mamba-7b (Mamba1, attention-free: d_model 4096, Di
   8192, d_state 16, dt_rank 256, vocab 65,024) and zamba2-2.7b (Mamba2
   blocks of 80 heads of 64, d_state 64, and a shared attention + GELU
   block of 32 heads of 80 after every 6; d_model 2560, vocab 32,000) at
   their published widths, bfloat16, 2 of 64 and 12 of 54 layers (the
   shared block twice, each time with its own KV cache), seed-0 random
   weights, compressed on the card under ITERA W4A8 r0.5 (R 2048, 128,
   16; R 1280, 64, 40) and quant-only W4A8, both with a W8A8 lm head;
   `generate` of 8 x 128 prompts, 16 new tokens, captured, greedy (and,
   mixed, sampled): launches exactly 11 / 61 of the plans' kernels a
   pass, none of paged_attention; prefill and decode times and a profile;
   card == CPU on 4 x 32 prompts, 8 new, greedy under both plans and
   sampled under the mixed one. Phase 2 compares every projection first
   through `ops` (W4, ITERA W4 at those ranks, the W8 heads) at M 8 and
   1024, the bf16-X-to-fp32-Y and fp32-X cases included, bit-equal, and
   times each launch key;
9. nemotron: nemotron-4-340b at its published widths (d_model 18432, 96
   heads of 192 over 8 KV heads, squared-ReLU d_ff 73728 -- six linears a
   layer --, LayerNorm with a bias, half the head dims rotary, vocab
   256,000), bfloat16, 1 of its 96 layers, seed-0 random weights,
   compressed on the card under ITERA W4A8 r0.0625 (R 1152, 64 for wk
   and wv; the reference's default 0.5 costs Alg. 1 about ten minutes a
   layer) with a W8A8 lm head and under quant-only W4A8; 8 requests of
   32-256 prompt tokens, 16 new, served captured with a bf16 and an int8
   pool: launches exactly 6 lowrank_qmm + 1 quant_matmul + 1
   paged_attention (mixed) or 7 quant_matmul + 1 paged_attention
   (quant-only) a step, every launch at a shape phase 2 compared (its
   K 18432 -> N 18432 / 1536 / 73728, K 73728 -> N 18432 and the K 18432
   -> N 256,000 head, both integer kernels bit-equal at every row count a
   step takes; bf16 attention at Dh 192 with a group of 12); card == CPU
   for 4 short requests, 8 new, on every path. The train phase also runs
   the train CLI of musicgen-medium's smoke config (the audio frontend:
   batches lifted to embeddings) on the card and on the CPU.

The last three lines are one JSON object with every kernel's numbers, the
card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL_ATTN = 1e-5          # attention: fp32 inputs, sums in another order
REPS = 10                # timed launches a Timer call


T_START = time.perf_counter()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


class PhaseFailed(Exception):
    pass


class Builds:
    """One `nvcc` per kernel library, each started on its own thread, so
    that phase 2 checks a kernel as soon as its own library is built;
    `wait(name)` joins that build and raises its error."""

    def __init__(self, build):
        self.t0 = time.perf_counter()
        self.secs: dict = {}
        self.errors: dict = {}
        self.threads = {name: threading.Thread(target=self._run,
                                               args=(build, name))
                        for name in build.SOURCES}
        for t in self.threads.values():
            t.start()

    def _run(self, build, name):
        try:
            self.secs.update(build.build([name]))
        except RuntimeError as e:       # nvcc failed: raised in wait()
            self.errors[name] = e

    def wait(self, name):
        self.threads[name].join()
        if name in self.errors:
            raise self.errors[name]

    def report(self) -> str:
        return (f"[build] {len(self.secs)} libraries built, the last "
                f"{time.perf_counter() - self.t0:.1f} s after the start (per "
                f"source: " + ", ".join(f"{k} {v:.1f} s"
                                        for k, v in self.secs.items()) + ")")


def check(failures: list, ok: bool, what: str) -> None:
    if not ok:
        failures.append(what)
        print(f"  FAIL {what}")


_PHASE_START = [T_START]


def end_phase(name: str, failures: list) -> None:
    """Raise if the phase failed; else print its seconds (since the last
    phase ended) and the script's."""
    if failures:
        raise PhaseFailed(f"phase {name}: {len(failures)} check(s) failed: "
                          + "; ".join(failures[:5]))
    now = time.perf_counter()
    print(f"[{name}] ok in {now - _PHASE_START[0]:.1f} s "
          f"({now - T_START:.0f} s since start)")
    _PHASE_START[0] = now


def bound(nbytes: float, ops: float, ops_rate: float):
    """(least ms, what bounds it) for moving `nbytes` through device memory
    and doing `ops` operations at `ops_rate` per second (the card's peaks:
    `repro_torch.hw.h100_model`, NVIDIA's H100 SXM data sheet at 700 W)."""
    from repro_torch.hw.h100_model import HBM_BW

    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / ops_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(text: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    nvcc's `-Xptxas -v` output; a template instantiation of the bf16
    attention kernel is named attend_bf16_kernel<Dh, QT, quant>."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            t = re.search(r"attend_bf16_kernelILi(\d+)ELi(\d+)ELb([01])E",
                          name)
            if t:
                name = "attend_bf16_kernel<%s, %s, %s>" % t.groups()
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            regs = out.get(name, (0, 0, 0))[0]
            out[name] = (regs, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            _, st, ld = out.get(name, (0, 0, 0))
            out[name] = (int(m.group(1)), st, ld)
    return out


def print_ptxas(failures) -> None:
    """Each kernel's registers and spills as ptxas reported them; the
    Dh 192 instantiations of the bf16 attention kernel (decode and
    prefill tiles, each over a bf16 and an int8 pool) must all be in the
    report, and none may spill."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import (BF16_QT_DECODE,
                                                     BF16_QT_PREFILL)

    dh192 = {f"attend_bf16_kernel<192, {qt}, {quant}>"
             for qt in (BF16_QT_DECODE, BF16_QT_PREFILL) for quant in (0, 1)}
    for lib in build.SOURCES:
        report = ptxas_report(build.log_path(lib).read_text())
        for name, (regs, st, ld) in sorted(report.items()):
            print(f"  {lib}: {name[:60]}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads")
            if name in dh192:
                check(failures, st == 0 and ld == 0,
                      f"{name} spills ({st} / {ld} bytes)")
        if lib == "paged_attention":
            missing = sorted(dh192 - set(report))
            check(failures, not missing,
                  f"ptxas reported no registers or spills for {missing}")


class HostGapped(float):
    """A Timer mean that includes the host's gaps between launches: it
    prints with a trailing "*", stays marked when scaled or rounded, and
    neither a kernel's time (`Timer.kernel`) nor the kernels' line
    (`finish`) accepts it."""

    def __format__(self, spec):
        return float.__format__(self, spec) + "*"

    def __mul__(self, other):
        return HostGapped(float(self) * other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return HostGapped(float(self) / other)

    def __round__(self, ndigits=None):
        return HostGapped(round(float(self), ndigits))


class Timer:
    """Mean device time of a call, from CUDA events around each launch.

    The L2 cache is flushed before each launch (the serving path
    streams other layers' weights between two calls of one kernel). The
    card is first held busy (`torch.cuda._sleep`) while the host queues
    every launch, so the events time the device alone and not the
    wrappers' Python, which would otherwise leave the card idle between
    them; if the queueing outlasts the hold, it is redone with a hold
    four times as long, up to HOLD_LIMIT, past which the mean is returned
    as a HostGapped value. Counts its calls, the rounds it redid, the
    means it marked and its seconds (`report`)."""

    def __init__(self, torch):
        from repro_torch.hw.h100_model import L2_BYTES

        self.torch = torch
        self.flush = torch.empty(3 * int(L2_BYTES), dtype=torch.uint8,
                                 device="cuda")
        self.calls = self.redone = self.gapped = 0
        self.seconds = 0.0

    def report(self) -> str:
        return (f"{self.calls} timer calls in {self.seconds:.1f} s, "
                f"{self.redone} rounds redone under a longer hold, "
                f"{self.gapped} means marked * (host gaps included)")

    def __call__(self, fn, reps: int = REPS) -> float:
        t0 = time.perf_counter()
        try:
            return self._time(fn, reps)
        finally:
            self.calls += 1
            self.seconds += time.perf_counter() - t0

    def _time(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        hold = HOLD_CYCLES
        while True:
            torch.cuda._sleep(hold)
            held = torch.cuda.Event()
            held.record()
            marks = []
            for _ in range(reps):
                self.flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                marks.append((start, end))
            starved = held.query()
            torch.cuda.synchronize()
            mean = sum(s.elapsed_time(e) for s, e in marks) / reps
            if not starved:
                return mean
            if hold >= HOLD_LIMIT:
                # something in `fn` waits for the card (an allocation
                # freeing cached memory), so no hold outlasts the queueing
                print(f"    (timer: the card idled between launches even "
                      f"under a {hold:.1e}-cycle hold; this time includes "
                      f"the host's gaps and is marked *)")
                self.gapped += 1
                return HostGapped(mean)
            self.redone += 1
            hold *= 4

    def kernel(self, fn) -> float:
        """A kernel's time: one that includes the host's gaps fails the
        run, since it would be printed as the kernel's device time."""
        t = self(fn)
        if isinstance(t, HostGapped):
            raise PhaseFailed(f"a kernel's time ({t:.4f} ms) includes the "
                              "host's gaps")
        return t


HOLD_CYCLES = 50_000_000  # a Timer call's first hold (~25 ms at 2 GHz)
HOLD_LIMIT = 3.2e9       # the longest hold a Timer tries (~1.6 s at 2 GHz)
GRAPH_LAUNCHES = 100     # launches of one kernel in a graph_ms graph


def graph_ms(torch, fn, n: int = GRAPH_LAUNCHES) -> float:
    """Device time of one call of `fn` replayed back to back with itself:
    `n` calls captured in one CUDA graph, the median of 5 replays, per
    call (as a captured serve step runs its launches; no L2 flush)."""
    import gc

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    gc.disable()            # no other graph may be freed during a capture
    try:
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
    finally:
        gc.enable()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / n)
    return sorted(per)[2]


# ------------------------------------------------------------- phase 2 --

def int_mm(torch, a, b):
    """torch._int_mm on int8 operands; cuBLAS needs more than 16 rows, so
    fewer are zero-padded to 32 (the extra rows are dropped)."""
    m = a.shape[0]
    if m <= 16:
        a = torch.nn.functional.pad(a, (0, 0, 0, 32 - m))
    return torch._int_mm(a, b)[:m]


def library_ms(timer, fn):
    """Time of a PyTorch library yardstick, or None with the reason when
    PyTorch refuses the shapes (the yardstick is never part of the port)."""
    try:
        return timer(fn)
    except RuntimeError as e:
        print(f"    library call refused: {str(e).splitlines()[0]}")
        return None


def check_quant_matmul(torch, timer, failures):
    from repro_torch.core.quant import QuantizedTensor, pack_int4, unpack_int4
    from repro_torch.hw.h100_model import PEAK_OPS_INT8
    from repro_torch.kernels.ops import qmm, qmm_hbm_bytes
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_plain)

    g = torch.Generator(device="cuda").manual_seed(1)
    rows, worst = [], 0.0
    print("  quant_matmul: M K N packed | kernel_ms plain_ms library_ms "
          "bound_us (bound by) | graph_us [ops_us at the dse batches]")
    layer = ((512, 512), (512, 2048), (2048, 512))
    cases = [(packed, m, k, n) for packed in (False, True)
             for m in (8, 256, 2048) for k, n in layer + ((512, 32000),)]
    # the speculative verify's lm head: k + 2 = 6 positions of 8 rows
    cases.append((False, 48, 512, 32000))
    # the quant-only plan's rectangular prefill: 8 prompts x a 128 bucket
    cases += [(True, 1024, k, n) for k, n in layer]
    # the dse phase's batch_m 512: W4 packed, W8 / W6 carriers, W8 lm head
    cases += [(packed, 512, k, n) for packed in (False, True)
              for k, n in layer]
    cases.append((False, 512, 512, 32000))
    # the moe phase's W8 lm head (deepseek-moe-16b: K 2048 -> N 102,400)
    cases.append((False, 8, 2048, 102400))
    for packed, m, k, n in cases:
        qm = 7 if packed else 127
        xq = torch.randint(-127, 128, (m, k), generator=g,
                           device="cuda", dtype=torch.int8)
        sx = torch.rand((m, 1), generator=g, device="cuda") + 0.01
        w = torch.randint(-qm, qm + 1, (k, n), generator=g,
                          device="cuda", dtype=torch.int8)
        wq = pack_int4(w) if packed else w
        sw = torch.rand((1, n), generator=g, device="cuda") * 0.01
        y = quant_matmul(xq, sx, wq, sw, w_packed=packed)
        ref = quant_matmul_plain(xq, sx, wq, sw, w_packed=packed)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        worst = max(worst, err)
        check(failures, torch.equal(y, ref),
              f"quant_matmul M={m} K={k} N={n} packed={packed} "
              f"differs from plain (max abs {err})")
        wc = unpack_int4(wq) if packed else wq
        t_k = timer.kernel(lambda: quant_matmul(xq, sx, wq, sw,
                                         w_packed=packed))
        t_p = timer(lambda: quant_matmul_plain(xq, sx, wq, sw,
                                               w_packed=packed))
        t_l = library_ms(timer, lambda: int_mm(torch, xq, wc).float()
                         * sx * sw)
        node = QuantizedTensor(wq, sw, 4 if packed else 8, 0, packed=packed)
        nbytes = qmm_hbm_bytes(m, node)
        b_ms, b_by = bound(nbytes, 2 * m * k * n, PEAK_OPS_INT8)
        t_g = graph_ms(torch, lambda: quant_matmul(xq, sx, wq, sw,
                                                   w_packed=packed))
        ops_ms = {}
        if m in DSE_BATCHES:    # the dse phase's engine comparison
            x = torch.randn((m, k), generator=g, device="cuda")
            ops_ms["baseline"] = timer(lambda: qmm(x, node))
        print(f"    {m:5d} {k:4d} {n:5d} {packed!s:5} | {t_k:.4f} "
              f"{t_p:.4f} {t_l if t_l is None else round(t_l, 4)} "
              f"{b_ms * 1e3:.4f} ({b_by}) | {t_g * 1e3:.2f} "
              + " ".join(f"{v * 1e3:.2f}" for v in ops_ms.values()))
        rows.append(dict(m=m, k=k, n=n, packed=packed, ms=t_k,
                         plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                         bound_by=b_by, graph_ms=t_g, ops_ms=ops_ms))
        TIMED["quant_matmul", m, k, n, packed] = rows[-1]
    slower_than_plain("quant_matmul", rows, ("m", "k", "n", "packed"))
    # the serving path's call: the W8 lm head, one row per batch slot
    main = next(r for r in rows if (r["m"], r["n"], r["packed"]) ==
                (8, 32000, False))
    return {**main, "max_abs_err": worst}


def check_lowrank_qmm(torch, timer, failures):
    from repro_torch.core.itera import LowRankQ
    from repro_torch.core.quant import (QuantizedTensor, pack_int4, packable,
                                        qmax)
    from repro_torch.hw.h100_model import PEAK_OPS_INT8
    from repro_torch.kernels.lowrank_qmm import (lowrank_qmm,
                                                 lowrank_qmm_plain)
    from repro_torch.kernels.ops import lrmm, lrmm_hbm_bytes, quantize_acts
    from repro_torch.kernels.ref import requant_rows

    g = torch.Generator(device="cuda").manual_seed(2)
    rows, worst = [], 0.0
    print("  lowrank_qmm: M K R N WxAy | kernel_ms plain_ms library_ms "
          "bound_us (bound by) | graph_us [ops_us at the dse batches, "
          "A8: cascade single]")
    layer = ((512, 512), (512, 2048), (2048, 512))   # a layer's (K, N)
    head = (512, 32000)                              # the lm head's
    cases = [(4, act_wl, m, k, 256, n) for act_wl in (8, 4)
             for m in (8, 2048) for k, n in layer]
    # the speculative path: the draft's truncated cascades at decode (R
    # 128 of rank fraction 0.5; R 160 and 192, where some CTAs of the
    # cluster get no rank columns; the A6 draft's clamp at R 128), and
    # the verify pass, 8 rows x a W 8 span at R 256
    cases += [(4, 8, 8, k, r, n) for r in (128, 160, 192) for k, n in layer]
    cases += [(4, 6, 8, k, 128, n) for k, n in layer]
    cases += [(4, 8, 64, k, 256, n) for k, n in layer]
    # the rectangular path's prefill: 8 prompts x a 128-token bucket
    cases += [(4, 8, 1024, k, 256, n) for k, n in layer]
    # the dse phase's batch_m 512 (the paper's batch; also its calibration
    # forward and a deployed prefill): ITERA W4 at rank fraction 0.375 and
    # 0.5, W8 (and W6, which launches alike on int8 carriers) at 0.5
    cases += [(wl, 8, 512, k, r, n) for wl, r in ((4, 192), (4, 256),
                                                  (8, 256))
              for k, n in layer]
    # the compression phase, unpacked W8 factors everywhere: at decode the
    # svd plan's R 384 (2 of 8 CTAs without rank columns), its draft's R
    # 192 and the SRA plans' 192 / 256 / 320, every linear and the lm
    # head as a cascade; the svd plan's speculative verify (64 rows, 48
    # at the lm head); the calibration forward's 8 x 256 rows at every
    # rank SRA probes (256 -+ its step of 64) and at the svd plan's 384
    full = layer + (head,)
    cases += [(8, 8, 8, k, r, n) for r in (192, 256, 320, 384)
              for k, n in full]
    cases += [(8, 8, 64, k, 384, n) for k, n in layer]
    cases += [(8, 8, 48, 512, 384, 32000)]
    cases += [(8, 8, 2048, k, r, n) for r in (192, 256, 320, 384)
              for k, n in full]
    # the moe phase's R 1024 cascades (deepseek-moe-16b's attention, K 2048
    # -> N 2048, and its shared experts, 2048 -> 2816 -> 2048) at each
    # tile height a serve step takes: 8 rows (W 1, 2), 32 (W 4), 2048
    cases += [(4, 8, m, k, 1024, n) for m in (8, 32, 2048)
              for k, n in MOE_DENSE]
    for wl, act_wl, m, k, r, n in cases:
        x = torch.randn((m, k), generator=g, device="cuda")
        xq, sx = quantize_acts(x, qmax(act_wl))
        qw = qmax(wl)
        w1c = torch.randint(-qw, qw + 1, (k, r), generator=g, device="cuda",
                            dtype=torch.int8)
        w2c = torch.randint(-qw, qw + 1, (r, n), generator=g, device="cuda",
                            dtype=torch.int8)
        w1p = packable(QuantizedTensor(w1c, None, wl, 0))
        w2p = packable(QuantizedTensor(w2c, None, wl, 1))
        w1 = pack_int4(w1c) if w1p else w1c
        w2 = pack_int4(w2c) if w2p else w2c
        s1 = torch.rand((1, r), generator=g, device="cuda") * 0.1
        s2 = torch.rand((r, 1), generator=g, device="cuda") * 0.1
        args = (xq, sx, w1, s1, w2, s2)
        kw = dict(w1_packed=w1p, w2_packed=w2p, act_qmax=qmax(act_wl))
        if m == 8:
            # the cascade property: no (M, R) buffer, only Y
            lowrank_qmm(*args, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            y = lowrank_qmm(*args, **kw)
            torch.cuda.synchronize()
            grown = torch.cuda.max_memory_allocated() - base
            check(failures, grown <= -(-m * n * 4 // 512) * 512,
                  f"lowrank_qmm allocated {grown} bytes beyond "
                  f"Y ({m * n * 4})")
        y = lowrank_qmm(*args, **kw)
        ref = lowrank_qmm_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        worst = max(worst, err)
        check(failures, torch.equal(y, ref),
              f"lowrank_qmm M={m} K={k} R={r} N={n} W{wl}A{act_wl} "
              f"differs from plain (max abs {err})")

        def chain():
            t = int_mm(torch, xq, w1c).float() * sx * s1 * \
                s2.reshape(1, -1)
            tq, st = requant_rows(t, qmax(act_wl))
            return int_mm(torch, tq, w2c).float() * st

        # the layer through ops: the cascade, and the single engine (two
        # quant_matmul launches, T through device memory), same bits
        node = LowRankQ(
            QuantizedTensor(w1, s1, wl, 0, packed=w1p, act_wl=act_wl),
            QuantizedTensor(w2, s2, wl, 1, packed=w2p, act_wl=act_wl))
        single = lrmm(x, node, fused=False)
        torch.cuda.synchronize()
        check(failures, torch.equal(single, ref),
              f"ops.lrmm(fused=False) M={m} K={k} R={r} N={n} W{wl}A{act_wl} "
              f"differs from plain")
        t_k = timer.kernel(lambda: lowrank_qmm(*args, **kw))
        t_p = timer(lambda: lowrank_qmm_plain(*args, **kw))
        t_l = library_ms(timer, chain)
        t_g = graph_ms(torch, lambda: lowrank_qmm(*args, **kw))
        ops_ms = {}
        if m in DSE_BATCHES and act_wl == 8:    # the dse phase's engines
            ops_ms = {"cascade": timer(lambda: lrmm(x, node)),
                      "single": timer(lambda: lrmm(x, node, fused=False))}
        nbytes = lrmm_hbm_bytes(m, node)
        b_ms, b_by = bound(nbytes, 2 * m * r * (k + n), PEAK_OPS_INT8)
        print(f"    {m:5d} {k:4d} {r:3d} {n:5d} W{wl}A{act_wl} | {t_k:.4f} "
              f"{t_p:.4f} {t_l if t_l is None else round(t_l, 4)} "
              f"{b_ms * 1e3:.4f} ({b_by}) | {t_g * 1e3:.2f} "
              + " ".join(f"{v * 1e3:.2f}" for v in ops_ms.values()))
        rows.append(dict(m=m, k=k, r=r, n=n, wl=wl, act_wl=act_wl, ms=t_k,
                         plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                         bound_by=b_by, graph_ms=t_g, ops_ms=ops_ms))
        TIMED["lowrank_qmm", m, k, r, n, wl, act_wl] = rows[-1]
    slower_than_plain("lowrank_qmm", rows, ("m", "k", "r", "n", "wl",
                                             "act_wl"))
    # the serving path's most frequent call: a decode step's attention
    # projection (wq/wk/wv/wo, K 512 -> N 512), 48 of its 72 launches
    main = next(r for r in rows
                if (r["m"], r["k"], r["r"], r["n"], r["wl"], r["act_wl"]) ==
                (8, 512, 256, 512, 4, 8))
    return {**main, "max_abs_err": worst}


# deepseek-moe-16b's widths in the moe phase: the routed experts' (K, N)
# (gate and up, down) at R 704, the linears that stay single matrices at R
# 1024 (attention, the shared experts' gate and up, their down), and the
# capacities of its steps that phase 2 times: a decode step (C 1), a
# W 32 chunk (30: tile height 32) and a W 256 chunk (240)
MOE_EXPERTS = ((2048, 1408), (1408, 2048))
MOE_DENSE = ((2048, 2048), (2048, 2816), (2816, 2048))
MOE_E, MOE_R_EXPERT = 64, 704
MOE_CAPACITIES = (1, 30, 240)


def check_expert_stacks(torch, failures):
    """Both integer kernels over deepseek-moe-16b's expert stacks, E 64,
    one launch a projection, at the moe phase's capacities: W4 `lowrank_qmm`
    at R 704 and W4 `quant_matmul` (the quant-only plan), packed where the
    packing rule packs the plan's factors. Each is held bit for bit to its
    plain version (their times are in PERF.md). Returns the worst max
    abs error."""
    from repro_torch.core.quant import pack_int4, packs
    from repro_torch.kernels.lowrank_qmm import (lowrank_qmm,
                                                 lowrank_qmm_plain)
    from repro_torch.kernels.ops import quantize_acts
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_plain)

    g = torch.Generator(device="cuda").manual_seed(5)
    e, r = MOE_E, MOE_R_EXPERT
    worst = 0.0

    def codes(*shape):
        return torch.randint(-7, 8, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    def stored(c, packed):
        return pack_int4(c) if packed else c

    for c in MOE_CAPACITIES:
        for k, n in MOE_EXPERTS:
            x = torch.randn((e, c, k), generator=g, device="cuda")
            xq, sx = quantize_acts(x, 127)
            # ---- the quant-only plan's expert projection
            wp = packs(4, n)
            wc = codes(e, k, n)
            sw = torch.rand((e, 1, n), generator=g, device="cuda") * 0.01
            wq = stored(wc, wp)
            y = quant_matmul(xq, sx, wq, sw, w_packed=wp)
            ref = quant_matmul_plain(xq, sx, wq, sw, w_packed=wp)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            worst = max(worst, err)
            check(failures, torch.equal(y, ref),
                  f"quant_matmul E={e} C={c} K={k} N={n} differs from plain "
                  f"(max abs {err})")
            # ---- the mixed plan's ITERA cascade at R 704
            w1p, w2p = packs(4, r), packs(4, n)
            w1c, w2c = codes(e, k, r), codes(e, r, n)
            s1 = torch.rand((e, 1, r), generator=g, device="cuda") * 0.1
            s2 = torch.rand((e, r, 1), generator=g, device="cuda") * 0.1
            args = (xq, sx, stored(w1c, w1p), s1, stored(w2c, w2p), s2)
            kw = dict(w1_packed=w1p, w2_packed=w2p, act_qmax=127)
            y = lowrank_qmm(*args, **kw)
            ref = lowrank_qmm_plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            worst = max(worst, err)
            check(failures, torch.equal(y, ref),
                  f"lowrank_qmm E={e} C={c} K={k} R={r} N={n} differs from "
                  f"plain (max abs {err})")
    return worst


def slower_than_plain(name, rows, keys) -> None:
    """A warning line for every shape where the kernel took longer than
    its plain version."""
    for r in rows:
        if r["ms"] > r["plain_ms"]:
            print(f"  WARNING: {name} "
                  + " ".join(f"{k}={r[k]}" for k in keys)
                  + f" is slower than its plain version: {r['ms']:.4f} ms "
                  f"against {r['plain_ms']:.4f} ms")


# lowrank_qmm's code paths that phase 2 held bit for bit to the plain
# version, as (bm, K, R, N, w1_packed, w2_packed, E): the keys of its
# launches in build.LAUNCH_SHAPES
COMPARED: set = set()
# ... and quant_matmul's (K, N) shapes that phase 2 compared
COMPARED_QMM: set = set()
# phase 2's rows by case, read by the dse phase:
# ("quant_matmul", M, K, N, packed), ("lowrank_qmm", M, K, R, N, wl, act_wl)
TIMED: dict = {}
DSE_BATCHES = (8, 512)   # co_design's batch_m: serve's decode rows, fig11's


def note_compared() -> None:
    """Add the launch keys counted since the last reset (phase 2's) to
    COMPARED and COMPARED_QMM."""
    from repro_torch.kernels import build

    for key in build.LAUNCH_SHAPES:
        if key[0] == "lowrank_qmm":
            COMPARED.add(key[1:])
        elif key[0] == "quant_matmul":
            COMPARED_QMM.add(key[1:])


def check_compared(failures, label) -> None:
    """Every lowrank_qmm launch counted since the last reset went through
    a code path that phase 2 compared with the plain version."""
    from repro_torch.kernels import build

    seen = {key[1:] for key in build.LAUNCH_SHAPES if key[0] == "lowrank_qmm"}
    check(failures, seen <= COMPARED,
          f"{label}: lowrank_qmm launched at (bm, K, R, N, w1_packed, "
          f"w2_packed, E) {sorted(seen - COMPARED)}, which phase 2 did not "
          f"compare with the plain version")


def lowrank_launch_shapes(cfg) -> dict:
    """Launches of lowrank_qmm per decode step by (K, N), from the model's
    geometry: every layer's wq/wk/wv/wo (d_model -> d_model), mlp/up
    (d_model -> d_ff) and mlp/down (d_ff -> d_model) are ITERA linears
    under the mixed plan."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.num_layers
    return {(d, d): 4 * n, (d, f): n, (f, d): n}


def quant_launch_shapes(cfg) -> dict:
    """Launches of quant_matmul per step by (K, N) under the quant-only
    plan: every layer's wq/wk/wv/wo, mlp/up and mlp/down, and the lm
    head."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.num_layers
    return {(d, d): 4 * n, (d, f): n, (f, d): n, (d, cfg.vocab_size): 1}


def _span_batch(torch, g, w, kv_bits, b=8, h=8, dh=64, bs=16, hk=None,
                dtype=None, lens=None):
    """A span batch over a pool with random history: ragged contexts, one
    idle row; decode (w == 1), speculative verify spans of 1 + 0-4
    drafts (w == 8), or prefill chunks up to w tokens; or the (contexts,
    query lengths) `lens`. Each row's table holds the blocks of its
    tokens, then the trash block 0. The pool has `hk` kv heads (default
    h); q and a kv-16 pool are fp32, or `dtype`."""
    hk = hk or h
    dtype = dtype or torch.float32
    if lens is not None:
        ctx, ql = lens
    elif w == 1:
        ctx = [40, 511, 0, 130, 300, 75, 220, 480]
        ql = [1, 1, 0, 1, 1, 1, 1, 1]
    elif w == 8:
        ctx = [40, 511, 0, 130, 300, 75, 220, 480]
        ql = [5, 3, 0, 1, 5, 2, 4, 5]
    else:
        ctx = [0, 256, 0, 17, 256, 500, 128, 0]
        ql = [w, 200, 0, 37, w, 1, 128, 90]
    mb = max(-(-(c + q) // bs) for c, q in zip(ctx, ql))
    table = torch.zeros((b, mb), dtype=torch.int32)
    nxt = 1
    for r in range(b):
        need = -(-(ctx[r] + ql[r]) // bs)
        table[r, :need] = torch.arange(nxt, nxt + need)
        nxt += need
    shape = (nxt, bs, hk, dh)
    if kv_bits == 8:
        pool = {"k": torch.randint(-127, 128, shape, generator=g,
                                   device="cuda", dtype=torch.int8),
                "v": torch.randint(-127, 128, shape, generator=g,
                                   device="cuda", dtype=torch.int8),
                # scales of |k|, |v| up to ~3, as the serving path's K/V
                "ks": torch.rand((*shape[:-1], 1), generator=g,
                                 device="cuda") * 0.02 + 0.005,
                "vs": torch.rand((*shape[:-1], 1), generator=g,
                                 device="cuda") * 0.02 + 0.005}
    else:
        pool = {"k": torch.randn(shape, generator=g, device="cuda").to(dtype),
                "v": torch.randn(shape, generator=g, device="cuda").to(dtype)}
    q = torch.randn((b, w, h, dh), generator=g, device="cuda").to(dtype)
    return (q, pool, table.cuda(), torch.tensor(ctx, dtype=torch.int32,
                                                device="cuda"),
            torch.tensor(ql, dtype=torch.int32, device="cuda"), ctx, ql)


def check_paged_attention(torch, timer, failures):
    from repro_torch.hw.h100_model import PEAK_FLOPS_FP32
    from repro_torch.kernels.paged_attention import (launch_work,
                                                     paged_attention,
                                                     span_attend_gather)

    g = torch.Generator(device="cuda").manual_seed(3)
    rows, worst = [], 0.0
    print("  paged_attention: W kv_bits H Dh | kernel_ms plain_ms library_ms "
          "bound_us (bound by) max_abs_err")
    # opus-mt's 8 heads of 64; the moe phase's 16 heads of 128 at decode
    # and in a W 256 prefill
    shapes = ((1, 8, 64), (8, 8, 64), (256, 8, 64), (1, 16, 128),
              (256, 16, 128))
    for kv_bits in (16, 8):
        for w, heads, dh in shapes:
            q, pool, table, ctx_t, _, ctx, _ = _span_batch(
                torch, g, w, kv_bits, h=heads, dh=dh)
            # every position of every row, past q_len and idle rows too
            o = paged_attention(q, pool, table, ctx_t)
            ref = span_attend_gather(q, pool, table, ctx_t)
            torch.cuda.synchronize()
            err = float((o - ref).abs().max())
            # key splits that end mid-block (40 keys of 16-slot blocks) and
            # more splits than a short row has blocks
            for kps in (40, 16):
                o2 = paged_attention(q, pool, table, ctx_t,
                                     keys_per_split=kps)
                torch.cuda.synchronize()
                err = max(err, float((o2 - ref).abs().max()))
            worst = max(worst, err)
            check(failures, err <= TOL_ATTN,
                  f"paged_attention W={w} Dh={dh} kv{kv_bits}: max abs {err} "
                  f"> {TOL_ATTN}")
            # yardstick: SDPA over the gathered (dequantized) K/V view
            b, _, h, dh = q.shape
            bs = pool["k"].shape[1]
            s = table.shape[1] * bs
            bt = table.long()

            def view(key):
                x = pool[key][bt].reshape(b, s, h, dh).float()
                if "ks" in pool:
                    x = x * pool[key[0] + "s"][bt].reshape(b, s, h, 1)
                return x.transpose(1, 2).contiguous()

            kk, vv = view("k"), view("v")
            qq = q.transpose(1, 2).contiguous()
            pos = ctx_t.long()[:, None] + torch.arange(w, device="cuda")
            mask = (torch.arange(s, device="cuda")[None, None, :]
                    <= pos[:, :, None])[:, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            t_k = timer.kernel(lambda: paged_attention(q, pool, table, ctx_t))
            t_p = timer(lambda: span_attend_gather(q, pool, table, ctx_t))
            t_l = library_ms(timer, lambda: sdpa(qq, kk, vv, attn_mask=mask))
            nbytes, flops = launch_work(table.tolist(), ctx, w, bs, h, dh,
                                        kv_bits=8 if kv_bits == 8 else 32,
                                        n_q_heads=h)
            b_ms, b_by = bound(nbytes, flops, PEAK_FLOPS_FP32)
            print(f"    {w:3d} kv{kv_bits} {h:2d} {dh:3d} | {t_k:.4f} "
                  f"{t_p:.4f} "
                  f"{t_l if t_l is None else round(t_l, 4)} {b_ms * 1e3:.4f} "
                  f"({b_by}) {err:.2e}")
            rows.append(dict(w=w, kv_bits=kv_bits, dh=dh, ms=t_k,
                             plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                             bound_by=b_by))
    # the serving path's most frequent call: a decode step, fp32 pool
    main = next(r for r in rows
                if (r["w"], r["kv_bits"], r["dh"]) == (1, 16, 64))
    return {**main, "max_abs_err": worst}


# bfloat16 models in the bf16 phase: phi3-medium-14b (d_model 5120, 40
# heads of 128 over 10 KV heads, d_ff 17920) under the mixed plan (ITERA
# W4A8 at the reference's default rank fraction 0.5: R 2560 for the
# 5120-wide factors, R 640 for wk and wv) and under quant-only W4A8, and
# stablelm-12b (32 heads of 160 over 8, d_ff 13824) under quant-only;
# both with the W8A8 lm head, K 5120 -> N 100,352. A serve step's linears
# take 8 x W rows, W a power of two up to the 256-token chunk. The gemma2
# phase's gemma2-9b (d_model 3584, 16 heads of 256 over 8, d_ff 14336)
# under ITERA W4A8 r0.5 (R 1792, and 1024 for wk and wv) and quant-only
# W4A8, its tied head a dense bf16 product; its generate takes 1-8 rows a
# decode step and up to 4,123 in a prefill or forward (the row counts
# above cover each launch's tile rows). The nemotron phase's
# nemotron-4-340b (d_model 18432, 96 heads of 192 over 8, relu2 d_ff 73728,
# vocab 256,000) under ITERA W4A8 at rank fraction 0.0625 (R 1152, and 64
# for wk and wv) and quant-only W4A8, both with the W8A8 lm head, K 18432
# -> N 256,000.
BF16_RANK_FRACTION = 0.5
BF16_ROWS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
BF16_ATTN = ((40, 10, 128), (32, 8, 160), (96, 8, 192))  # (H, Hk, Dh)
TOL_ULP_SHARE = 1e-4     # bf16 attention: share of outputs 1 ulp apart
# bf16 attention: a decode whose longest row reaches 4096 keys (8 key
# splits), and key splits forced mid-block (W 1 and 256)
BF16_LONG_DECODE = ([4095, 1000, 0, 2047, 3000, 17, 4000, 511],
                    [1, 1, 0, 1, 1, 1, 1, 1])
BF16_FORCED_SPLITS = ((1, 100), (256, 200))   # (W, keys_per_split)


def bf16_geometry():
    """The bf16, gemma2 and nemotron phases' linears: {(K, N): (wl,
    packed)} of quant_matmul (the quant-only plans' layer linears and the
    W8 lm heads) and {(K, R, N)} of lowrank_qmm (the mixed plans', at the
    ranks their uniform plans give), from the four configs."""
    from repro_torch.configs import get_config
    from repro_torch.core.compress import CompressionConfig
    from repro_torch.core.quant import packs

    fractions = {"phi3-medium-14b": BF16_RANK_FRACTION, "stablelm-12b": None,
                 "gemma2-9b": GEMMA2_RANK_FRACTION,
                 "nemotron-4-340b": NEMOTRON_RANK_FRACTION}
    qmm, lrmm = {}, set()
    for arch, fraction in fractions.items():
        c = get_config(arch)
        d, f = c.d_model, c.d_ff
        q, kv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
        shapes = ((d, q), (d, kv), (q, d), (d, f), (f, d))
        for k, n in shapes:
            qmm[k, n] = (4, packs(4, n))
        if not c.tie_embeddings:
            qmm[d, c.vocab_size] = (8, False)           # the W8 lm head
        if fraction is not None:
            rule = CompressionConfig(rank_fraction=fraction)
            for k, n in shapes:
                lrmm.add((k, rule.rank_for("", (k, n)), n))
    return qmm, sorted(lrmm)


def _ulp_share(torch, o, ref):
    """(max abs difference, share of elements that differ, whether each
    difference is within one bf16 ulp of the larger value)."""
    a, b = o.float(), ref.float()
    diff = (a - b).abs()
    ulp = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7
    return (float(diff.max()), float((diff > 0).float().mean()),
            bool((diff <= ulp).all()))


# the tp phase's per-rank launches (opus-mt full: d_model 512, 8 heads of
# 64, d_ff 2048): (K, R, N, wl) of lowrank_qmm -- at tp 1 the mixed plan's
# own; at tp 2 its N-sites (K 512, N 256 / 1024) and K-sites (K 256 /
# 1024, N 512) at R 256, the svd plan's N-sites at R 384 (W8) and its
# draft's R 64 --, (K, N) of the quant-only plan's packed W4 quant_matmul
# at tp 2 with a bf16 Y, and the W8 head; attention at 4 heads of 64. A
# step takes 8 x W rows, W a power of two up to the 256-token chunk.
TP_LOWRANK = ((512, 256, 512, 4), (512, 256, 2048, 4), (2048, 256, 512, 4),
              (512, 256, 256, 4), (512, 256, 1024, 4), (256, 256, 512, 4),
              (1024, 256, 512, 4), (512, 384, 256, 8), (512, 384, 1024, 8),
              (512, 64, 256, 8), (512, 64, 1024, 8))
TP_QMM = ((512, 256), (512, 1024), (256, 512), (1024, 512))


def check_tp_kernels(torch, failures):
    """Phase 2 for the tp phase: every per-rank launch shape at tp 2
    through `ops` (so padded and packed as served), at every row count of
    BF16_ROWS, bit-equal to the plain versions on the same tensors (fp32
    Y for the cascades, bf16 Y for the quant-only plan and its W8 head);
    paged attention at 4 heads of 64 over fp32 / int8 pools (within
    TOL_ATTN) and bf16 (within one bf16 ulp on at most TOL_ULP_SHARE of
    the outputs), decode, verify and a W 256 prefill. Compared, not
    timed. Returns {kernel: worst max abs error}."""
    from repro_torch.core.itera import LowRankQ
    from repro_torch.core.quant import QuantizedTensor, pack_weights
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     span_attend_gather)

    g = torch.Generator(device="cuda").manual_seed(28)
    worst = collections.Counter()

    def node(k, n, wl, axis, scale_shape):
        qm = 7 if wl == 4 else 127
        codes = torch.randint(-qm, qm + 1, (k, n), generator=g,
                              device="cuda", dtype=torch.int8)
        scale = torch.rand(scale_shape, generator=g, device="cuda") * 0.02
        return pack_weights(QuantizedTensor(codes, scale, wl, axis))

    cases = [(LowRankQ(node(k, r, wl, 0, (1, r)), node(r, n, wl, 1, (r, 1))),
              torch.float32, ops.lrmm, f"K={k} R={r} N={n} W{wl}")
             for k, r, n, wl in TP_LOWRANK]
    cases += [(node(k, n, 4, 0, (1, n)), torch.bfloat16, ops.qmm,
               f"K={k} N={n} W4") for k, n in TP_QMM]
    cases += [(node(512, 32000, 8, 0, (1, 32000)), yd, ops.qmm,
               "lm head K=512 N=32000 W8") for yd in (torch.float32,
                                                      torch.bfloat16)]
    for w, yd, fn, what in cases:
        kernel = "lowrank_qmm" if fn is ops.lrmm else "quant_matmul"
        k = (w.w1 if kernel == "lowrank_qmm" else w).shape[0]
        rows = (8,) if "lm head" in what else BF16_ROWS
        for m in rows:
            x = torch.randn((m, k), generator=g, device="cuda")
            if yd == torch.bfloat16:
                x = x.to(yd)
            y = fn(x, w, out_dtype=yd)
            ref = plain_linear(torch, x, w, yd)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            worst[kernel] = max(worst[kernel], err)
            check(failures, torch.equal(y.view(torch.int16),
                                        ref.view(torch.int16))
                  if yd == torch.bfloat16 else torch.equal(y, ref),
                  f"tp {kernel} M={m} {what} differs from plain (max abs "
                  f"{err})")
    for dtype, kv_bits in ((torch.float32, 16), (torch.float32, 8),
                           (torch.bfloat16, 16), (torch.bfloat16, 8)):
        for w in (1, 8, 256):
            q, pool, table, ctx_t, *_ = _span_batch(
                torch, g, w, kv_bits, h=4, dh=64, dtype=dtype)
            o = paged_attention(q, pool, table, ctx_t)
            ref = span_attend_gather(q, pool, table, ctx_t)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                err = float((o - ref).abs().max())
                ok = err <= TOL_ATTN
            else:
                err, share, ulp = _ulp_share(torch, o, ref)
                ok = ulp and share <= TOL_ULP_SHARE
            worst["paged_attention"] = max(worst["paged_attention"], err)
            check(failures, ok, f"tp paged_attention 4 heads of 64 W={w} "
                  f"{dtype} kv{kv_bits}: max abs {err}")
    print(f"  tp per-rank shapes: {len(cases)} linears at up to "
          f"{len(BF16_ROWS)} row counts and 12 attention cases compared, "
          f"worst {dict(worst)}")
    return dict(worst)


def check_bf16_kernels(torch, failures):
    """Phase 2 for the bf16 models: both integer kernels with their bf16
    epilogue at every (rows, K, [R,] N) a bf16 serve step launches,
    bit-equal to the plain versions, and paged attention at bf16 with a
    bf16 or int8 pool, Dh 128, 160 and 192, decode and a W 256 prefill, a
    4096-key decode and forced key splits, within one bf16 ulp on at most
    TOL_ULP_SHARE of the outputs (their times are in PERF.md).
    Returns {kernel: worst max abs error}."""
    from repro_torch.core.quant import QuantizedTensor, pack_int4, packable
    from repro_torch.kernels.lowrank_qmm import (lowrank_qmm,
                                                 lowrank_qmm_plain)
    from repro_torch.kernels.ops import quantize_acts
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     span_attend_gather)
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_plain)

    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(21)
    worst = collections.Counter()
    qmm_shapes, lrmm_shapes = bf16_geometry()
    for (k, n), (wl, packed) in sorted(qmm_shapes.items()):
        # the widest shapes' plain versions take GBs of float64 blocks: a
        # cache full of other shapes' blocks would make them wait on frees
        torch.cuda.empty_cache()
        qm = 7 if wl == 4 else 127
        w = torch.randint(-qm, qm + 1, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        wq = pack_int4(w) if packed else w
        sw = torch.rand((1, n), generator=g, device="cuda") * 0.01
        # the lm head takes one row per batch slot, the layers every M
        for m in ((8,) if wl == 8 else BF16_ROWS):
            xq = torch.randint(-127, 128, (m, k), generator=g,
                               device="cuda", dtype=torch.int8)
            sx = torch.rand((m, 1), generator=g, device="cuda") + 0.01
            args = (xq, sx, wq, sw)
            kw = dict(w_packed=packed, out_dtype=bf)
            y = quant_matmul(*args, **kw)
            ref = quant_matmul_plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            worst["quant_matmul"] = max(worst["quant_matmul"], err)
            check(failures, torch.equal(y.view(torch.int16),
                                        ref.view(torch.int16)),
                  f"bf16 quant_matmul M={m} K={k} N={n} differs from "
                  f"plain (max abs {err})")
    for k, r, n in lrmm_shapes:
        torch.cuda.empty_cache()
        w1c = torch.randint(-7, 8, (k, r), generator=g, device="cuda",
                            dtype=torch.int8)
        w2c = torch.randint(-7, 8, (r, n), generator=g, device="cuda",
                            dtype=torch.int8)
        w1p = packable(QuantizedTensor(w1c, None, 4, 0))
        w2p = packable(QuantizedTensor(w2c, None, 4, 1))
        w1 = pack_int4(w1c) if w1p else w1c
        w2 = pack_int4(w2c) if w2p else w2c
        s1 = torch.rand((1, r), generator=g, device="cuda") * 0.1
        s2 = torch.rand((r, 1), generator=g, device="cuda") * 0.1
        kw = dict(w1_packed=w1p, w2_packed=w2p, act_qmax=127, out_dtype=bf)
        for m in BF16_ROWS:
            x = torch.randn((m, k), generator=g, device="cuda").to(bf)
            xq, sx = quantize_acts(x, 127)
            args = (xq, sx, w1, s1, w2, s2)
            y = lowrank_qmm(*args, **kw)
            ref = lowrank_qmm_plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            worst["lowrank_qmm"] = max(worst["lowrank_qmm"], err)
            check(failures, torch.equal(y.view(torch.int16),
                                        ref.view(torch.int16)),
                  f"bf16 lowrank_qmm M={m} K={k} R={r} N={n} differs from "
                  f"plain (max abs {err})")

    def compare(label, q, pool, table, ctx_t, **kw):
        o = paged_attention(q, pool, table, ctx_t, **kw)
        ref = span_attend_gather(q, pool, table, ctx_t)
        torch.cuda.synchronize()
        err, share, in_ulp = _ulp_share(torch, o, ref)
        worst["paged_attention"] = max(worst["paged_attention"], err)
        check(failures, in_ulp and share <= TOL_ULP_SHARE,
              f"bf16 paged_attention {label}: {share:.2e} of outputs differ "
              f"(at most {TOL_ULP_SHARE}), all within one ulp: {in_ulp}")
        return err, share

    print("  bf16 paged_attention: W kv_bits H Hk Dh | max_abs_err "
          "share_differing")
    for kv_bits in (16, 8):
        for h, hk, dh in BF16_ATTN:
            for w in (1, 256):
                q, pool, table, ctx_t, *_ = _span_batch(
                    torch, g, w, kv_bits, h=h, dh=dh, hk=hk, dtype=bf)
                err, share = compare(f"W={w} H={h} Dh={dh} kv{kv_bits}", q,
                                     pool, table, ctx_t)
                print(f"    W {w:3d} kv{kv_bits} {h:2d} {hk:2d} {dh:3d} | "
                      f"{err:.2e} {share:.2e}")
    for h, hk, dh in BF16_ATTN:
        for kv_bits in (16, 8):
            batch = _span_batch(torch, g, 1, kv_bits, h=h, dh=dh, hk=hk,
                                dtype=bf, lens=BF16_LONG_DECODE)
            err, share = compare(f"4096-key decode H={h} Dh={dh} "
                                 f"kv{kv_bits}", *batch[:4])
            print(f"    4096-key decode kv{kv_bits} {h:2d} {hk:2d} "
                  f"{dh:3d} | {err:.2e} {share:.2e}")
        for w, kps in BF16_FORCED_SPLITS:
            batch = _span_batch(torch, g, w, 16, h=h, dh=dh, hk=hk, dtype=bf)
            err, share = compare(f"W={w} H={h} Dh={dh} keys_per_split={kps}",
                                 *batch[:4], keys_per_split=kps)
            print(f"    W {w} keys_per_split {kps} {h:2d} {hk:2d} "
                  f"{dh:3d} | {err:.2e} {share:.2e}")
    return dict(worst)


# lowrank_qmm's ranks past the served ones, (K, R, N, E): wide slices
# with a partial last one (R 1056), the widest slice (R 4096), the
# smallest rank on the grouped path (R 4128, T through device memory),
# a grouped rank of 72 slices (R 9216), and an expert stack past 1024
LARGE_RANKS = ((2048, 1056, 2048, 1), (4096, 4096, 4096, 1),
               (4096, 4128, 4096, 1), (9216, 9216, 9216, 1),
               (2048, 1280, 2048, 8))
LARGE_ROWS = (8, 2048)


def check_large_ranks(torch, failures):
    """lowrank_qmm at LARGE_RANKS, W4 packed where the rule packs, M 8 and
    2048 rows (each expert's), an fp32 and a bf16 Y, bit-equal to the
    plain version (their times are in PERF.md); also the bf16,
    gemma2 and nemotron phases' served ranks with an fp32 Y at those rows
    (the bf16 Y is compared in `check_bf16_kernels`). Returns the worst
    max abs error."""
    from repro_torch.core.quant import QuantizedTensor, pack_int4, packable
    from repro_torch.hw.h100_model import NUM_SMS
    from repro_torch.kernels import lowrank_qmm as lr
    from repro_torch.kernels.ops import quantize_acts

    g = torch.Generator(device="cuda").manual_seed(23)
    worst = 0.0
    _, served = bf16_geometry()
    shapes = [(k, r, n, e, True) for k, r, n, e in LARGE_RANKS] + [
        (k, r, n, 1, False) for k, r, n in served]
    for k, r, n, e, both in shapes:
        lead = (e,) if e > 1 else ()
        w1c = torch.randint(-7, 8, (*lead, k, r), generator=g,
                            device="cuda", dtype=torch.int8)
        w2c = torch.randint(-7, 8, (*lead, r, n), generator=g,
                            device="cuda", dtype=torch.int8)
        w1p = packable(QuantizedTensor(w1c, None, 4, 0))
        w2p = packable(QuantizedTensor(w2c, None, 4, 1))
        w1 = pack_int4(w1c) if w1p else w1c
        w2 = pack_int4(w2c) if w2p else w2c
        s1 = torch.rand((*lead, 1, r), generator=g, device="cuda") * 0.1
        s2 = torch.rand((*lead, r, 1), generator=g, device="cuda") * 0.1
        for m in LARGE_ROWS:
            x = torch.randn((*lead, m, k), generator=g, device="cuda")
            xq, sx = quantize_acts(x, 127)
            args = (xq, sx, w1, s1, w2, s2)
            path = lr.choose_tiles(m, r, n, NUM_SMS, lr.smem_bytes, e).path
            dtypes = ((torch.float32, torch.bfloat16) if both
                      else (torch.float32,))
            for dt in dtypes:
                kw = dict(w1_packed=w1p, w2_packed=w2p, act_qmax=127,
                          out_dtype=dt)
                y = lr.lowrank_qmm(*args, **kw)
                ref = lr.lowrank_qmm_plain(*args, **kw)
                torch.cuda.synchronize()
                err = float((y.float() - ref.float()).abs().max())
                worst = max(worst, err)
                same = (torch.equal(y.view(torch.int16),
                                    ref.view(torch.int16))
                        if dt == torch.bfloat16 else torch.equal(y, ref))
                check(failures, same,
                      f"lowrank_qmm M={m} K={k} R={r} N={n} E={e} ({path}, "
                      f"{dt}) differs from plain (max abs {err})")
    return worst


# ------------------------------------------------- phase 2: the Mamba shapes --
# of falcon-mamba-7b's 64 layers and zamba2-2.7b's 54 (two groups of six:
# the shared block runs twice, each time with its own KV cache)
MAMBA_DEPTHS = {"falcon-mamba-7b": 2, "zamba2-2.7b": 12}
MAMBA_RANK_FRACTION = 0.5
MAMBA_ROWS = (8, 1024)          # a decode step's rows, the 8 x 128 prefill's
MAMBA_TIMED = (8, 128, 16)      # generate: prompts x tokens, new tokens
MAMBA_SHORT = (4, 32, 8)        # the card == CPU generate


def mamba_geometry():
    """The mamba phase's linears by arch: [(name, K, N, X dtype, Y dtype)]
    of every projection both plans compress (the quant-only plan's W4, the
    mixed plan's ITERA at MAMBA_RANK_FRACTION) and the W8 lm head, with the
    activation and output dtypes the bf16 model gives them: dt_in,
    bc_proj and dt_lin take a bf16 X to an fp32 Y, dt_proj an fp32 X."""
    from repro_torch.configs import get_config

    out = {}
    for arch in MAMBA_DEPTHS:
        c = get_config(arch)
        d, s = c.d_model, c.ssm
        di = d * s.expand
        if s.version == 1:
            dtr = s.dt_rank or d // 16
            lin = [("in_proj", d, 2 * di, "bf16", "bf16"),
                   ("dt_in", di, dtr, "bf16", "fp32"),
                   ("bc_proj", di, 2 * s.d_state, "bf16", "fp32"),
                   ("dt_proj", dtr, di, "fp32", "fp32"),
                   ("out_proj", di, d, "bf16", "bf16")]
        else:
            q = c.num_heads * c.head_dim
            kv = c.num_kv_heads * c.head_dim
            lin = [("zx_proj", d, 2 * di, "bf16", "bf16"),
                   ("bc_in", d, 2 * s.d_state, "bf16", "bf16"),
                   ("dt_lin", d, di // s.head_dim, "bf16", "fp32"),
                   ("out_proj", di, d, "bf16", "bf16"),
                   ("wq", d, q, "bf16", "bf16"), ("wk", d, kv, "bf16", "bf16"),
                   ("wv", d, kv, "bf16", "bf16"), ("wo", q, d, "bf16", "bf16"),
                   ("up", d, c.d_ff, "bf16", "bf16"),
                   ("down", c.d_ff, d, "bf16", "bf16")]
        out[arch] = lin + [("lm_head", d, c.vocab_size, "bf16", "fp32")]
    return out


def plain_linear(torch, x, node, out_dtype):
    """What `ops.qmm` / `ops.lrmm` compute for `node`, through the kernels'
    plain versions on the same tensors."""
    from repro_torch.core.itera import LowRankQ
    from repro_torch.core.quant import qmax
    from repro_torch.kernels.lowrank_qmm import lowrank_qmm_plain
    from repro_torch.kernels.ops import quantize_acts
    from repro_torch.kernels.quant_matmul import quant_matmul_plain

    xq, sx = quantize_acts(x, qmax(node.act_wl))
    if isinstance(node, LowRankQ):
        r = node.rank
        return lowrank_qmm_plain(
            xq, sx, node.w1.values, node.w1.scale.reshape(1, r),
            node.w2.values, node.w2.scale.reshape(r, 1),
            w1_packed=node.w1.packed, w2_packed=node.w2.packed,
            act_qmax=qmax(node.act_wl), out_dtype=out_dtype)
    return quant_matmul_plain(xq, sx, node.values, node.scale.reshape(1, -1),
                              w_packed=node.packed, out_dtype=out_dtype)


def check_mamba_kernels(torch, timer, failures):
    """Phase 2 for the mamba phase: every projection of `mamba_geometry`
    as the served path launches it -- through `ops.qmm` (W4, packed where
    the rule packs; the W8 head) and `ops.lrmm` (ITERA W4 at the plans'
    rank), K, R and N padded as `ops` pads them -- at MAMBA_ROWS rows,
    bit-equal to the plain versions on the same tensors (the activations'
    quantization included), with the fp32-X and fp32-Y cases; each launch
    key is timed once at both row counts beside its bound, the plain
    version and the `_int_mm` yardstick, all three on the kernel's own
    quantized activations. Returns {kernel: worst max abs error}."""
    from repro_torch.core.compress import CompressionConfig
    from repro_torch.core.itera import LowRankQ
    from repro_torch.core.quant import (QuantizedTensor, pack_weights,
                                        unpack_int4)
    from repro_torch.hw.h100_model import PEAK_OPS_INT8
    from repro_torch.kernels import ops
    from repro_torch.kernels.lowrank_qmm import (lowrank_qmm,
                                                 lowrank_qmm_plain)
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_plain)
    from repro_torch.kernels.ref import requant_rows

    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}
    g = torch.Generator(device="cuda").manual_seed(26)
    worst = collections.Counter()
    rule = CompressionConfig(rank_fraction=MAMBA_RANK_FRACTION)
    rows, seen = [], set()

    def node(k, n, wl, axis, scale_shape):
        qm = 7 if wl == 4 else 127
        codes = torch.randint(-qm, qm + 1, (k, n), generator=g,
                              device="cuda", dtype=torch.int8)
        scale = torch.rand(scale_shape, generator=g, device="cuda") * 0.02
        return pack_weights(QuantizedTensor(codes, scale, wl, axis))

    def codes_of(q):
        return unpack_int4(q.values) if q.packed else q.values

    print("  mamba linears: arch name kernel M K [R] N X->Y packed | "
          "kernel_ms plain_ms library_ms bound_us (bound by)")
    for arch, lins in mamba_geometry().items():
        for name, k, n, xd, yd in lins:
            torch.cuda.empty_cache()
            wl = 8 if name == "lm_head" else 4
            nodes = [node(k, n, wl, 0, (1, n))]
            if name != "lm_head":
                r = rule.rank_for("", (k, n))
                nodes.append(LowRankQ(node(k, r, 4, 0, (1, r)),
                                      node(r, n, 4, 1, (r, 1))))
            for w in nodes:
                lowrank = isinstance(w, LowRankQ)
                kernel = "lowrank_qmm" if lowrank else "quant_matmul"
                for m in ((8,) if name == "lm_head" else MAMBA_ROWS):
                    x = torch.randn((m, k), generator=g, device="cuda").to(
                        dt[xd])
                    fn = ops.lrmm if lowrank else ops.qmm
                    y = fn(x, w, out_dtype=dt[yd])
                    ref = plain_linear(torch, x, w, dt[yd])
                    torch.cuda.synchronize()
                    err = float((y.float() - ref.float()).abs().max())
                    worst[kernel] = max(worst[kernel], err)
                    same = (torch.equal(y.view(torch.int16),
                                        ref.view(torch.int16))
                            if yd == "bf16" else torch.equal(y, ref))
                    r_txt = f" R={w.rank}" if lowrank else ""
                    check(failures, same,
                          f"mamba {arch} {name} {kernel} M={m} K={k}{r_txt} "
                          f"N={n} {xd}->{yd} differs from plain (max abs "
                          f"{err})")
                    key = (kernel, m, k, w.rank if lowrank else 0, n, xd, yd)
                    if key in seen:
                        continue
                    seen.add(key)
                    qm = 127
                    xq, sx = ops.quantize_acts(x, qm)
                    if lowrank:
                        r = w.rank
                        s1 = w.w1.scale.reshape(1, r)
                        s2 = w.w2.scale.reshape(r, 1)
                        args = ops._lrmm_args(xq, sx, w.w1.values, s1,
                                              w.w2.values, s2, w.w1.packed,
                                              w.w2.packed)
                        kw = dict(w1_packed=w.w1.packed,
                                  w2_packed=w.w2.packed, act_qmax=qm,
                                  out_dtype=dt[yd])
                        w1c, w2c = codes_of(w.w1), codes_of(w.w2)

                        def launch():
                            return lowrank_qmm(*args, **kw)

                        def plain():
                            return lowrank_qmm_plain(*args, **kw)

                        def chain():
                            t = int_mm(torch, xq, w1c).float() * sx * s1 * \
                                s2.reshape(1, -1)
                            tq, st = requant_rows(t, qm)
                            return (int_mm(torch, tq, w2c).float() * st).to(
                                dt[yd])

                        nbytes = ops.lrmm_hbm_bytes(
                            m, w, out_bytes=2 if yd == "bf16" else 4)
                        nops = 2 * m * r * (k + n)
                        packed = (w.w1.packed, w.w2.packed)
                    else:
                        sw = w.scale.reshape(1, n)
                        args = ops._qmm_args(xq, sx, w.values, sw, w.packed)
                        kw = dict(w_packed=w.packed, out_dtype=dt[yd])
                        wc = codes_of(w)

                        def launch():
                            return quant_matmul(*args, **kw)

                        def plain():
                            return quant_matmul_plain(*args, **kw)

                        def chain():
                            return (int_mm(torch, xq, wc).float() * sx
                                    * sw).to(dt[yd])

                        nbytes = ops.qmm_hbm_bytes(
                            m, w, out_bytes=2 if yd == "bf16" else 4)
                        nops = 2 * m * k * n
                        packed = w.packed
                    t_k = timer.kernel(launch)
                    t_p = timer(plain)
                    t_l = library_ms(timer, chain)
                    b_ms, b_by = bound(nbytes, nops, PEAK_OPS_INT8)
                    print(f"    {arch} {name} {kernel} {m:5d} {k:5d}"
                          f"{r_txt} {n:6d} {xd}->{yd} {packed} | "
                          f"{t_k:.4f} {t_p:.4f} "
                          f"{t_l if t_l is None else round(t_l, 4)} "
                          f"{b_ms * 1e3:.4f} ({b_by})")
                    rows.append(dict(kernel=kernel, m=m, k=k, n=n, ms=t_k,
                                     plain_ms=t_p))
    for kernel in ("quant_matmul", "lowrank_qmm"):
        slower_than_plain(f"mamba {kernel}",
                          [r for r in rows if r["kernel"] == kernel],
                          ("m", "k", "n"))
    return dict(worst)


# ------------------------------------------------------- phases 3 and 4 --

EXCLUDE = r"(embed|norm|ln|lm_head)"
# the moe phase also keeps the router float, as the reference's default
MOE_EXCLUDE = r"(embed|router|norm|ln|lm_head)"


def mixed_plan(params, exclude=EXCLUDE, power_iters=24):
    from repro_torch.api.plan import CompressionPlan, LayerPlan

    base = CompressionPlan.uniform(params, method="itera", weight_wl=4,
                                   rank_fraction=0.5, exclude=exclude,
                                   power_iters=power_iters)
    return base.replace(layers=base.layers + (LayerPlan("lm_head", "quant",
                                                        8),),
                        label="itera_W4A8_r0.5+lm_head_W8A8")


def quant_plan(params, exclude=EXCLUDE):
    """The paper's quantization-only baseline: W4A8 for every attention and
    MLP linear (the §V-A engine, `quant_matmul`, for all of them) and the
    mixed plan's W8A8 lm head."""
    from repro_torch.api.plan import CompressionPlan, LayerPlan

    base = CompressionPlan.uniform(params, method="quant", weight_wl=4,
                                   exclude=exclude)
    return base.replace(layers=base.layers + (LayerPlan("lm_head", "quant",
                                                        8),),
                        label="quant_W4A8+lm_head_W8A8")


def workload(vocab: int, seed: int = 0):
    """16 requests of 32-512 prompt tokens; four share a 64-token prefix
    (four full 16-token blocks for the prefix cache)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, 64).astype(np.int32)
    reqs = []
    for i in range(16):
        n = int(rng.integers(32, 513))
        toks = rng.integers(1, vocab, n).astype(np.int32)
        if i % 4 == 1:
            toks = np.concatenate([prefix, toks[:max(n - 64, 1)]])
        reqs.append(toks)
    return reqs


def device_rows(prof) -> list:
    """(card ms, events, name) of each name among a finished profile's
    device-side events (kernels, copies, memsets; the host ops that
    launched them carry the same time again), summed straight from the
    trace: `prof.key_averages()` builds the profiler's per-op event tree
    first, which took 14-28 s for the 118k events of an opus-mt serve."""
    acc = collections.defaultdict(lambda: [0, 0])
    for e in prof.profiler.kineto_results.events():
        if (str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0
                and not e.is_user_annotation()):
            a = acc[e.name()]
            a[0] += e.duration_ns()
            a[1] += 1
    return [(ns / 1e6, n, key) for key, (ns, n) in acc.items()]


def profile_run(torch, run, label: str):
    """`run()` (a serve, a generate or train steps, returning its number of
    steps) once more under torch.profiler: the card's busy share of the
    wall time, its device events (kernels, copies, memsets) a step and the
    card's idle time per event, its time by kernel, and the linears'
    kernels' (quant_matmul's and lowrank_qmm's) card time per step. Only
    the card's activity is traced: recording every host op as well slowed
    the host, and so the wall, by more than the run took in a serve of
    thousands of launches. Informational, nothing is checked;
    a profiler that cannot trace the card is reported and skipped (None
    is returned, else the (card ms, events, name) rows)."""
    from torch.profiler import ProfilerActivity, profile

    t_all = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps = run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = device_rows(prof)
    except Exception as e:      # the profiler is optional here
        print(f"[profile] not available: {type(e).__name__}: {e}")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    events = sum(r[1] for r in rows)
    gap_us = (wall_ms - busy) * 1e3 / max(events, 1)
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, card busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy / wall_ms):.1f}%; {events} device events, "
          f"{events / steps:.1f} a step, {gap_us:.2f} us idle an event; "
          f"{time.perf_counter() - t_all:.1f} s with the profiler's own work")
    for ms, n, key in rows[:10]:
        print(f"  {ms:9.3f} ms {n:7d} x  {key[:90]}")
    lin = [(ms, n) for ms, n, key in rows
           if "qmm_kernel" in key or "lrmm_kernel" in key]
    ms = sum(r[0] for r in lin)
    print(f"[profile] {label}: linears (quant_matmul, lowrank_qmm) "
          f"{ms:.3f} ms of card time over {sum(r[1] for r in lin)} "
          f"launches in {steps} steps = {ms / steps:.4f} ms a step")
    return rows


def host_us_per_call(torch, fn, reps: int = 200) -> float:
    """Wall time of one call of `fn` in microseconds, over `reps` calls
    issued back to back: what the Python around a launch costs the serve
    loop, since the card finishes each launch long before the host has
    issued the next one (unless a call waits for the card, which then
    counts too)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def compare_plans(torch, engines, reqs, sp):
    """The two plans' fp32-KV serves side by side in one process, in the
    order A B B A (so that drift over the run falls on both alike), and
    the host time of one decode-step linear call under each plan
    (`apply_linear` on 8 rows: quantize, pad, wrapper, launch). Printed
    only: the end-to-end metrics users see, apart from the card time
    `profile_run` reads."""
    from repro_torch.models.layers import apply_linear

    names = list(engines)
    for label in names + names[::-1]:
        eng = engines[label]
        res = eng.serve(reqs, sp)
        torch.cuda.synchronize()
        print(f"[compare] {label}: TPOT p50 {res.tpot_p50 * 1e3:.2f} ms, "
              f"TTFT p50 {res.ttft_p50 * 1e3:.1f} ms, "
              f"{res.tokens_per_second:.1f} tok/s, wall "
              f"{res.seconds / res.steps * 1e3:.2f} ms a step over "
              f"{res.steps} steps")
    for label in names:
        eng = engines[label]
        layer = eng._step_params["layers"][0]
        for what, w in (("attn/wq", layer["attn"]["wq"]),
                        ("mlp/up", layer["mlp"]["up"]),
                        ("mlp/down", layer["mlp"]["down"])):
            x = torch.randn((8, getattr(w, "w1", w).shape[0]),
                            device=eng.device)
            us = host_us_per_call(torch, lambda: apply_linear(x, w))
            print(f"[compare] {label}: host {us:.1f} us per {what} call "
                  f"({type(w).__name__}, 8 rows)")


def last_logits(torch, eng, toks):
    """Logits after `toks`, from one prefill step on a fresh pool."""
    from repro_torch.models.transformer import unified_step
    from repro_torch.runtime.kvblocks import init_paged_cache

    n, bs = len(toks), eng.block_size
    mb = -(-n // bs)
    pool = init_paged_cache(eng.cfg, mb + 1, bs, eng.device)
    dev = eng.device
    table = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)[None]
    with torch.inference_mode():
        logits, _ = unified_step(
            eng._step_params, pool, table,
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev),
            torch.tensor(toks, dtype=torch.int32, device=dev)[None], eng.cfg)
    return logits[0, -1].float().cpu()


def build_engine(torch, cfg, make_plan):
    """Random full-width weights from seed 0, compressed on the card by the
    port under `make_plan(params)`, in an fp32-KV engine of 8 rows."""
    from repro_torch.api.engine import InferenceEngine
    from repro_torch.models.transformer import init_params

    params = init_params(cfg, seed=0, device="cuda")
    plan = make_plan(params)
    print(f"[engine] {plan.summary()}")
    t0 = time.perf_counter()
    eng = InferenceEngine.build(cfg, plan, params=params, device="cuda",
                                max_batch=8, block_size=16)
    torch.cuda.synchronize()
    print(f"[engine] compressed in {time.perf_counter() - t0:.1f} s: "
          f"{eng.report.summary()}; weights "
          f"{eng.weight_hbm_bytes() / 2**20:.1f} MiB on the card")
    return eng


def serve_checked(torch, eng, kv, reqs, sp, before, failures):
    """Serve `reqs`, print the serve's numbers and the launches since
    `before`, and check the outputs' shape and range."""
    import numpy as np

    from repro_torch.kernels import build

    res = eng.serve(reqs, sp)
    torch.cuda.synchronize()
    counts = {k: build.LAUNCHES[k] - before.get(k, 0) for k in build.SOURCES}
    print(f"[engine] {eng.plan.label} {kv}: {len(reqs)} requests, prompts "
          f"{min(res.prompt_lens)}-{max(res.prompt_lens)} tokens, "
          f"{res.total_tokens} tokens in {res.seconds:.3f} s = "
          f"{res.tokens_per_second:.1f} tok/s; TTFT p50 "
          f"{res.ttft_p50 * 1e3:.1f} ms, TPOT p50 "
          f"{res.tpot_p50 * 1e3:.2f} ms; {res.steps} steps "
          f"({res.mixed_steps} mixed); prefix cache "
          f"{res.cache_hit_blocks}/{res.cache_lookup_blocks} blocks, "
          f"{res.cache_cow_blocks} COW; launches {counts}")
    out = np.stack(res.outputs)
    vocab = eng.cfg.vocab_size
    check(failures, out.shape == (len(reqs), sp.max_tokens),
          f"{kv}: outputs {out.shape}")
    check(failures, bool(((out >= 0) & (out < vocab)).all()),
          f"{kv}: token ids out of range")
    return res


SPEC = dict(k=4, rank_fraction=0.5)      # the speculation phase's draft


def sampling_phase(torch, eng, reqs, greedy, failures):
    """The mixed plan's fp32-KV engine serving `reqs` sampled
    (temperature 0.8, top-k 50, top-p 0.9, seed 7), four requests
    overriding to temperature 0: those must give `greedy`'s tokens (the
    phase-3 serve); a second serve, and one with the prefix cache off,
    must give the first's tokens; then four requests get an eos id or a
    2-token stop sequence from their own run, and each output must be
    `match_stop_host` of that run, streamed alike through on_token.
    Returns the first serve's result and its kernel launches."""
    import numpy as np

    from repro_torch.api.engine import SamplingParams
    from repro_torch.kernels import build
    from repro_torch.runtime.sampling import match_stop_host
    from repro_torch.runtime.scheduler import Request

    sp = SamplingParams(max_tokens=32, temperature=0.8, top_k=50, top_p=0.9,
                        seed=7)
    cold = (0, 4, 8, 12)

    def requests(stops=None):
        return [Request(tokens=t, temperature=0.0) if i in cold
                else Request(tokens=t, **(stops or {}).get(i, {}))
                for i, t in enumerate(reqs)]

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a.outputs, b.outputs))

    build.reset_launches()                  # the sampling path's run starts
    res = eng.serve(requests(), sp)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)         # ... and ends here
    check_compared(failures, "sampling")
    print(f"[sampling] {len(reqs)} requests, {len(cold)} at temperature 0: "
          f"{res.total_tokens} tokens, TPOT p50 {res.tpot_p50 * 1e3:.2f} ms "
          f"(greedy {greedy.tpot_p50 * 1e3:.2f}), "
          f"{res.tokens_per_second:.1f} tok/s (greedy "
          f"{greedy.tokens_per_second:.1f}), {res.steps} steps; launches "
          f"{launches}")
    for i in cold:
        check(failures, np.array_equal(res.outputs[i], greedy.outputs[i]),
              f"sampling: temperature-0 request {i} differs from greedy")
    check(failures, any(not np.array_equal(res.outputs[i], greedy.outputs[i])
                        for i in range(len(reqs)) if i not in cold),
          "sampling: every sampled request gave the greedy tokens")
    check(failures, same(res, eng.serve(requests(), sp)),
          "sampling: a second seeded serve differs")
    check(failures, same(res, eng.serve(requests(), sp, prefix_cache=False)),
          "sampling: the serve with the prefix cache off differs")
    out = res.outputs
    stops = {1: {"eos_id": int(out[1][8])}, 6: {"eos_id": int(out[6][20])},
             10: {"stop": ((int(out[10][5]), int(out[10][6])),)},
             15: {"stop": ((int(out[15][25]), int(out[15][26])),)}}
    events = []
    st = eng.serve(requests(stops), sp, on_token=events.append)
    early = 0
    for i in range(len(reqs)):
        stop = stops.get(i, {})
        keep = match_stop_host(out[i], stop.get("eos_id"),
                               stop.get("stop", ()), sp.max_tokens)
        early += keep < sp.max_tokens
        check(failures, np.array_equal(st.outputs[i], out[i][:keep]),
              f"sampling: request {i} with stops {stop}: "
              f"{st.outputs[i].size} tokens, match_stop_host gives {keep}")
        evs = [e for e in events if e.rid == i]
        check(failures, [e.token for e in evs] == st.outputs[i].tolist()
              and [e.index for e in evs] == list(range(len(evs)))
              and [e.final for e in evs] == [False] * (len(evs) - 1) + [True],
              f"sampling: request {i}'s on_token events differ from its "
              f"output")
    check(failures, early == len(stops) and st.stopped_early == early,
          f"sampling: {st.stopped_early} requests stopped early, "
          f"{early} expected")
    print(f"[sampling] with stops: lengths "
          f"{[st.outputs[i].size for i in sorted(stops)]} of requests "
          f"{sorted(stops)}; {st.steps} steps, {len(events)} events")
    return res, launches


def speculation_phase(torch, eng, eng8, reqs, greedy16, greedy8, failures):
    """The mixed plan's engines with DraftSpec(**SPEC): greedy speculative
    serves of `reqs` must give the plain serves' tokens (`greedy16`,
    `greedy8`, phase 3), with the draft's truncated cascades (R 128 at
    full width) launched 4 x 72 times a drafting round and the full ones (R 256) 72
    times a step. Plain and speculative fp32-KV serves are timed A B B A.
    Then the served model as its own draft (rank fraction 1.0), whose
    drafts are accepted: phase 3's tokens again.
    Returns the first speculative serve's launches."""
    import numpy as np

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.kernels import build
    from repro_torch.runtime.speculation import DraftSpec, draft_rank

    spec = DraftSpec(**SPEC)
    seng, seng8 = (InferenceEngine(e.cfg, e.params, device=e.device,
                                   plan=e.plan, max_batch=8, block_size=16,
                                   speculate=spec) for e in (eng, eng8))
    sp = SamplingParams(max_tokens=32)
    seng.serve(reqs[:2], SamplingParams(max_tokens=3))      # warm-up
    torch.cuda.synchronize()
    runs = [("plain", eng.serve(reqs, sp))]
    build.reset_launches()                  # the speculative path's run
    res = seng.serve(reqs, sp)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)         # ... ends here
    ranks = dict(build.LAUNCH_RANKS)
    check_compared(failures, "speculation")
    runs += [("speculative", res), ("speculative", seng.serve(reqs, sp)),
             ("plain", eng.serve(reqs, sp))]
    torch.cuda.synchronize()
    for label, r in runs:
        print(f"[speculation] {label}: TPOT p50 {r.tpot_p50 * 1e3:.2f} ms, "
              f"{r.tokens_per_second:.1f} tok/s, {r.steps} steps, drafted "
              f"{r.drafted}, accepted {r.accepted}, rounds {r.spec_rounds}, "
              f"accept rate {r.accept_rate:.4f}")
    per_pass = sum(lowrank_launch_shapes(eng.cfg).values())
    # the plan's cascade rank (256 at full width) and the draft's (128),
    # as the kernel takes them, padded to 32
    full_r, = {lp.rank for lp in eng.plan.layers if lp.method == "itera"}
    r_draft = -(-draft_rank(full_r, spec.rank_fraction) // 32) * 32
    r_full = -(-full_r // 32) * 32
    print(f"[speculation] launches {launches}; lowrank_qmm by rank {ranks} "
          f"over {res.steps} steps, {res.spec_rounds} drafting rounds")
    check(failures, ranks.get(r_draft, 0) > 0,
          f"speculation: no lowrank_qmm launch at the draft's R {r_draft}")
    check(failures, ranks.get(r_draft, 0) == SPEC["k"] * per_pass
          * res.spec_rounds, f"speculation: {ranks.get(r_draft, 0)} R "
          f"{r_draft} launches, expected {SPEC['k']} x {per_pass} a "
          f"drafting round")
    check(failures, ranks.get(r_full, 0) == per_pass * res.steps,
          f"speculation: {ranks.get(r_full, 0)} R {r_full} launches, "
          f"expected {per_pass} a step")
    for label, r in runs:
        check(failures, all(np.array_equal(a, b) for a, b in
                            zip(r.outputs, greedy16.outputs)),
              f"speculation: the {label} fp32-KV serve's tokens differ "
              f"from phase 3's")
    r8 = seng8.serve(reqs, sp)
    print(f"[speculation] int8 KV: drafted {r8.drafted}, accepted "
          f"{r8.accepted}, accept rate {r8.accept_rate:.4f}")
    check(failures, all(np.array_equal(a, b) for a, b in
                        zip(r8.outputs, greedy8.outputs)),
          "speculation: the int8-KV speculative tokens differ from phase 3's")
    # the served model as its own draft (rank fraction 1.0): drafts are
    # accepted, so rounds emit up to k + 1 tokens and keep their draft
    # blocks, the path random weights at rank fraction 0.5 rarely take
    exact = InferenceEngine(eng.cfg, eng.params, device=eng.device,
                            plan=eng.plan, max_batch=8, block_size=16,
                            speculate=DraftSpec(k=SPEC["k"],
                                                rank_fraction=1.0))
    rx = exact.serve(reqs, sp)
    torch.cuda.synchronize()
    print(f"[speculation] exact draft: TPOT p50 {rx.tpot_p50 * 1e3:.2f} ms, "
          f"{rx.tokens_per_second:.1f} tok/s, {rx.steps} steps, drafted "
          f"{rx.drafted}, accepted {rx.accepted}, accept rate "
          f"{rx.accept_rate:.4f}")
    check(failures, all(np.array_equal(a, b) for a, b in
                        zip(rx.outputs, greedy16.outputs)),
          "speculation: the exact draft's tokens differ from phase 3's")
    return launches


SRA_BOUND = dict(max_iters=2, patience=1)   # keeps SRA near a minute
CALIB = (2, 8, 256)         # calibration batches x rows x tokens


def svd_plan(params):
    """The paper's SVD-then-quantize baseline as fig13 serves it: every
    eligible linear (the lm head included) W8A8 at rank fraction 0.75,
    R 384 at full width."""
    from repro_torch.api.plan import CompressionPlan

    return CompressionPlan.uniform(params, method="svd", weight_wl=8,
                                   rank_fraction=0.75)


def ranks_per_step(cfg, plan) -> dict:
    """lowrank_qmm launches of one forward pass (a serving step) under
    `plan`, by rank padded to 32 as the kernel takes it: one per layer for
    each low-rank stacked leaf, one for each other low-rank leaf."""
    per = collections.Counter()
    for lp in plan.layers:
        if lp.method in ("svd", "itera"):
            per[-(-lp.rank // 32) * 32] += (cfg.num_layers if
                                             lp.path.startswith("layers/")
                                             else 1)
    return dict(per)


def quant_per_step(cfg, plan, params) -> dict:
    """quant_matmul launches of one forward pass under `plan`, by (K, N):
    one per layer for each quantized stacked leaf, one for each other."""
    from repro_torch.core.compress import param_leaves_by_path

    leaves = param_leaves_by_path(params)
    per = collections.Counter()
    for lp in plan.layers:
        if lp.method == "quant":
            k, n = (int(d) for d in leaves[lp.path].shape[-2:])
            per[k, n] += (cfg.num_layers if lp.path.startswith("layers/")
                          else 1)
    return dict(per)


def check_plan_launches(failures, label, res, counts, ranks, per_rank,
                        n_layers, per_shape=None):
    """Every low-rank linear of the plan on `lowrank_qmm`, `per_rank`
    launches a step at each rank; every quantized one on `quant_matmul`,
    `per_shape` launches a step by (K, N) (none by default); one attention
    launch a layer; every cascade on a code path phase 2 compared."""
    from repro_torch.kernels import build

    per_step = sum(per_rank.values())
    check(failures, counts.get("lowrank_qmm", 0) == per_step * res.steps,
          f"{label}: {counts.get('lowrank_qmm', 0)} lowrank_qmm launches, "
          f"expected {per_step} a step x {res.steps} steps")
    check(failures, ranks == {r: c * res.steps for r, c in per_rank.items()},
          f"{label}: lowrank_qmm launches by rank {ranks}, expected "
          f"{per_rank} a step x {res.steps} steps")
    check(failures, counts.get("paged_attention", 0) == n_layers * res.steps,
          f"{label}: {counts.get('paged_attention', 0)} paged_attention "
          f"launches, expected {n_layers} a step")
    shapes = {key[1:]: c for key, c in build.LAUNCH_SHAPES.items()
              if key[0] == "quant_matmul"}
    want = {kn: c * res.steps for kn, c in (per_shape or {}).items()}
    check(failures, shapes == want
          and counts.get("quant_matmul", 0) == sum(want.values()),
          f"{label}: quant_matmul launches by (K, N) {shapes}, expected "
          f"{per_shape or {}} a step x {res.steps} steps")
    check_compared(failures, label)


def compression_phase(torch, cfg, reqs, failures):
    """The paper's compression flow on the card, on full-width weights
    from seed 0 whose spectra are shaped to s_i ~ i^-2: the svd W8 plan
    (ratio, each leaf's reconstruction error, ITERA W4 against SVD W4 at
    the same rank, which it must not exceed), served greedy with its 73
    R-384 lowrank_qmm launches a step checked, and speculatively with a
    rank-0.5 draft (the plain serve's tokens); then SRA over the
    calibration forward (greedy next-token agreement with the
    uncompressed model on CALIB tokens, half the summed maximum ranks,
    SRA_BOUND iterations, launches by rank checked against the
    allocations it evaluated) and a greedy serve of its allocation -- and
    of its last move when it kept equal ranks, so unequal ranks run on the
    card too. Returns ({label: engine} for parity, {path: launches} of the
    kernel runs, and (the shaped weights, the calibration's quality
    function of a compressed tree) for the dse phase)."""
    import numpy as np

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.core.compress import (CompressionConfig, flatten,
                                           shape_spectra, sra_eval_closure)
    from repro_torch.core.itera import (itera_decompose,
                                        reconstruction_error, svd_decompose)
    from repro_torch.core.sra import sra_allocate
    from repro_torch.kernels import build
    from repro_torch.models.transformer import (forward, init_params,
                                                logits_for)
    from repro_torch.runtime.speculation import DraftSpec, draft_rank

    sp = SamplingParams(max_tokens=32)
    t0 = time.perf_counter()
    shaped = shape_spectra(init_params(cfg, seed=0, device="cuda"), 2.0)
    torch.cuda.synchronize()
    print(f"[compression] shape_spectra(alpha 2.0) on the host: "
          f"{time.perf_counter() - t0:.2f} s")

    plan = svd_plan(shaped)
    t0 = time.perf_counter()
    eng = InferenceEngine.build(cfg, plan, params=shaped, device="cuda",
                                max_batch=8, block_size=16)
    torch.cuda.synchronize()
    print(f"[compression] {plan.summary()}: compressed on the card in "
          f"{time.perf_counter() - t0:.2f} s, ratio "
          f"{eng.report.compression_ratio:.3f}x; {eng.report.summary()}")
    (rank,) = {lp.rank for lp in plan.layers}
    leaves, nodes = flatten(shaped), flatten(eng.params)
    t0 = time.perf_counter()
    for lp in plan.layers:
        w = leaves[lp.path]
        e8 = float(reconstruction_error(w, nodes[lp.path]))
        e_it = float(reconstruction_error(w, itera_decompose(w, rank, 4)))
        e_sv = float(reconstruction_error(w, svd_decompose(w, rank, 4)))
        print(f"  {lp.path:18s} {tuple(w.shape)} R {rank}: svd W8 error "
              f"{e8:.5f}; W4 itera {e_it:.5f} vs svd {e_sv:.5f}")
        check(failures, e_it <= e_sv, f"{lp.path}: ITERA W4 error {e_it} "
              f"exceeds SVD W4's {e_sv} at R {rank}")
    print(f"[compression] ITERA and SVD W4 of every leaf on the card in "
          f"{time.perf_counter() - t0:.1f} s")

    launches = {}
    eng.serve(reqs[:2], SamplingParams(max_tokens=2))        # warm-up
    torch.cuda.synchronize()
    build.reset_launches()                  # the svd plan's serve starts
    plain = serve_checked(torch, eng, "kv16", reqs, sp, {}, failures)
    launches["svd"] = dict(build.LAUNCHES)  # ... and ends here
    per_rank = ranks_per_step(cfg, plan)
    (rp, per_step), = per_rank.items()      # every cascade at R 384
    check_plan_launches(failures, "svd plan", plain, launches["svd"],
                        dict(build.LAUNCH_RANKS), per_rank, cfg.num_layers)

    spec = DraftSpec(**SPEC)
    seng = InferenceEngine(cfg, eng.params, device=eng.device, plan=eng.plan,
                           max_batch=8, block_size=16, speculate=spec)
    seng.serve(reqs[:2], SamplingParams(max_tokens=3))       # warm-up
    torch.cuda.synchronize()
    build.reset_launches()                  # the speculative serve starts
    sres = seng.serve(reqs, sp)
    torch.cuda.synchronize()
    launches["svd speculative"] = dict(build.LAUNCHES)      # ... ends here
    ranks = dict(build.LAUNCH_RANKS)
    rd = -(-draft_rank(rank, spec.rank_fraction) // 32) * 32
    print(f"[compression] svd plan: plain TPOT p50 "
          f"{plain.tpot_p50 * 1e3:.2f} ms, {plain.tokens_per_second:.1f} "
          f"tok/s, {plain.steps} steps; speculative (k {spec.k}, draft R "
          f"{rd}) TPOT p50 {sres.tpot_p50 * 1e3:.2f} ms, "
          f"{sres.tokens_per_second:.1f} tok/s, {sres.steps} steps, "
          f"accepted {sres.accepted} of {sres.drafted} drafts = accept rate "
          f"{sres.accept_rate:.4f} over {sres.spec_rounds} rounds; "
          f"lowrank_qmm by rank {ranks}")
    check(failures, all(np.array_equal(a, b) for a, b in
                        zip(sres.outputs, plain.outputs)),
          "svd plan: the speculative tokens differ from the plain serve's")
    check(failures, ranks.get(rd, 0) == spec.k * per_step * sres.spec_rounds,
          f"svd plan: {ranks.get(rd, 0)} R {rd} launches, expected "
          f"{spec.k} x {per_step} a drafting round")
    check(failures, ranks.get(rp, 0) == per_step * sres.steps,
          f"svd plan: {ranks.get(rp, 0)} R {rp} launches, expected "
          f"{per_step} a step")
    check_compared(failures, "svd plan speculative")

    # SRA: next-token agreement with the uncompressed model on CALIB
    g = torch.Generator().manual_seed(0)
    nb, rows, seq = CALIB
    calib = [torch.randint(1, cfg.vocab_size, (rows, seq), generator=g,
                           dtype=torch.int32).cuda() for _ in range(nb)]

    def greedy(p, toks):
        with torch.inference_mode():
            return logits_for(p, forward(p, toks, cfg)[0], cfg).argmax(-1)

    ref = [greedy(shaped, t) for t in calib]

    def quality(cp) -> float:
        return float(sum((greedy(cp, t) == r).float().mean()
                         for t, r in zip(calib, ref)) / nb)

    scfg = CompressionConfig(method="svd", weight_wl=8)
    eval_fn, paths, max_ranks = sra_eval_closure(shaped, scfg, quality)
    evaluated = []

    def recorded(alloc):
        evaluated.append(list(alloc))
        return eval_fn(alloc)

    def config(alloc):
        return dataclasses.replace(scfg, ranks=dict(zip(paths, alloc)))

    budget = sum(max_ranks) // 2
    t0 = time.perf_counter()
    build.reset_launches()                  # SRA's calibration starts
    res = sra_allocate(recorded, len(paths), budget, max_ranks, **SRA_BOUND)
    torch.cuda.synchronize()
    launches["sra calibration"] = dict(build.LAUNCHES)      # ... ends here
    ranks = dict(build.LAUNCH_RANKS)
    expect = collections.Counter()
    for alloc in evaluated:                 # one forward pass a batch
        for r, c in ranks_per_step(cfg, config(alloc).to_plan(shaped)).items():
            expect[r] += nb * c
    print(f"[sra] {len(paths)} layers, budget {budget} of {sum(max_ranks)} "
          f"ranks, {SRA_BOUND}: {res.evals} evaluations (each compresses "
          f"the model and runs {nb} x {rows} x {seq} tokens) in "
          f"{time.perf_counter() - t0:.1f} s; launches "
          f"{launches['sra calibration']}; lowrank_qmm by rank {ranks}")
    check(failures, len(evaluated) == res.evals,
          f"sra: {len(evaluated)} evaluations ran, the result counts "
          f"{res.evals}")
    check(failures, ranks == dict(expect),
          f"sra: calibration launches by rank {ranks}, the evaluated "
          f"allocations give {dict(expect)}")
    check_compared(failures, "sra calibration")
    for it, (alloc, acc) in enumerate(res.history):
        print(f"  iteration {it}: {alloc} agreement {acc:.5f}")
    print(f"[sra] allocation {dict(zip(paths, res.ranks))}, agreement "
          f"{res.accuracy:.5f}")
    check(failures, sum(res.ranks) == budget,
          f"sra: allocation sums to {sum(res.ranks)}, budget {budget}")
    check(failures, launches["sra calibration"].get("lowrank_qmm", 0) > 0,
          "sra: the calibration forward launched no lowrank_qmm")

    served = {"sra": res.ranks}
    if len(set(res.ranks)) == 1:
        # SRA kept the equal split: its last move is served too, so an
        # allocation with unequal ranks runs on the card
        moved = next((a for a, _ in reversed(res.history)
                      if len(set(a)) > 1), None)
        check(failures, moved is not None,
              "sra: no allocation with unequal ranks in the history")
        if moved is not None:
            served["sra move"] = moved
    engines = {"svd": eng}
    for label, alloc in served.items():
        e = InferenceEngine.build(cfg, config(alloc), params=shaped,
                                  device="cuda", max_batch=8, block_size=16)
        per_rank = ranks_per_step(cfg, e.plan)
        print(f"[sra] {label} {e.plan.summary()}: ranks "
              f"{[lp.rank for lp in e.plan.layers]}, lowrank_qmm launches "
              f"a step by rank {per_rank}; {e.report.summary()}")
        e.serve(reqs[:2], SamplingParams(max_tokens=2))     # warm-up
        torch.cuda.synchronize()
        build.reset_launches()              # the allocation's serve starts
        r = serve_checked(torch, e, "kv16", reqs, sp, {}, failures)
        launches[label] = dict(build.LAUNCHES)  # ... and ends here
        check_plan_launches(failures, label, r, launches[label],
                            dict(build.LAUNCH_RANKS), per_rank,
                            cfg.num_layers)
        engines[label] = e
    return engines, launches, (shaped, quality)




def dse_candidates(params):
    """The dse phase's candidate plans, each with the mixed plan's W8A8 lm
    head: quant-only W8, W6 and W4; ITERA W8, W6 and W4 at rank fraction
    0.5 (R 256) and W4 at 0.375 (R 192). meta["engines_allowed"] names the
    engine each serves on, so the model prices the deployed launches."""
    from repro_torch.api.plan import CompressionPlan, LayerPlan, merge_plans

    head = [LayerPlan("lm_head", "quant", 8)]
    out = []
    for method, wl, frac in ([("quant", wl, 0.5) for wl in (8, 6, 4)]
                             + [("itera", wl, 0.5) for wl in (8, 6, 4)]
                             + [("itera", 4, 0.375)]):
        base = CompressionPlan.uniform(params, method=method, weight_wl=wl,
                                       rank_fraction=frac,
                                       exclude=r"(embed|norm|ln|lm_head)")
        rank = f"_r{frac:g}" if method == "itera" else ""
        out.append(merge_plans(base, head).replace(
            label=f"{method}_W{wl}A8{rank}+lm_head_W8A8",
            meta={"engines_allowed": ["cascade" if method == "itera"
                                      else "baseline"]}))
    return out


def spearman(a, b) -> float:
    """Rank correlation of two sequences (tied values share their mean
    rank)."""
    import numpy as np

    def ranks(x):
        x = np.asarray(x, dtype=float)
        r = np.empty(len(x))
        r[np.argsort(x, kind="stable")] = np.arange(len(x))
        for v in np.unique(x):
            r[x == v] = r[x == v].mean()
        return r

    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def _launch_keys(shapes, m):
    """{phase 2's row key: (engine, wl)} of the launches a plan's layers
    make at M rows, A8: a quantized layer on quant_matmul (packed where
    `packs` says), a low-rank one on lowrank_qmm (W4, or the W8 row for
    W6 and W8, which launch alike on int8 carriers)."""
    from repro_torch.core.quant import packs

    keys = {}
    for l in shapes:
        if l.rank is None:
            keys["quant_matmul", m, l.k, l.n, packs(l.wl, l.n)] = (
                "baseline", l.wl)
        else:
            keys["lowrank_qmm", m, l.k, l.rank, l.n, 4 if l.wl == 4 else 8,
                 8] = ("cascade", l.wl)
    return keys


def model_row(key, engine, wl, failures) -> dict:
    """The H100 model beside phase 2's row `key`: its prediction with
    LAUNCH_S and with none (and the single engine's, for a low-rank
    layer), and the gates that the model priced the partition the
    wrapper launches (the choosers at the library's shared-memory layout
    and the card's SMs; for lowrank_qmm, a tile-row count phase 2's
    launches took) and that each Python `smem_bytes` mirror equals the
    library's there."""
    from repro_torch.core.quant import packs
    from repro_torch.hw import h100_model as hm
    from repro_torch.kernels import build
    from repro_torch.kernels import lowrank_qmm as lr
    from repro_torch.kernels import quant_matmul as qm

    sms = build.sm_count(0)
    qlib = build.load("quant_matmul", qm._SIGNATURES)
    m, k = key[1:3]
    row = dict(TIMED[key])
    if engine == "baseline":
        n, packed = key[3:5]
        point = hm.dense_engine(m, k, n, weight_wl=wl)
        row["pred0"] = hm.dense_engine(m, k, n, weight_wl=wl,
                                       launch_s=0.0).latency_s
        t = qm.choose_tiles(m, k, n, packed, sms, qlib.qmm_smem_bytes)
        used, priced = [t._asdict()], [point.config["tiles"]]
        mirror = [(qm.smem_bytes, qlib.qmm_smem_bytes,
                   (*t[:3], int(packed), t.cluster, t.kslice))]
    else:
        r, n = key[3:5]
        w1p, w2p = packs(wl, r), packs(wl, n)
        point = hm.cascade_engine(m, k, n, r, weight_wl=wl)
        row["pred0"] = hm.cascade_engine(m, k, n, r, weight_wl=wl,
                                         launch_s=0.0).latency_s
        sp = hm.single_engine(m, k, n, r, weight_wl=wl)
        row["single"] = (sp.latency_s, hm.single_engine(
            m, k, n, r, weight_wl=wl, launch_s=0.0).latency_s)
        lib = build.load("lowrank_qmm", lr._SIGNATURES)
        t = lr.choose_tiles(m, r, n, sms, lib.lrmm_smem_bytes)
        check(failures, (t.bm, k, r, n, w1p, w2p, 1) in COMPARED,
              f"dse: {key}: phase 2 launched no bm {t.bm} partition")
        t1 = qm.choose_tiles(m, k, r, w1p, sms, qlib.qmm_smem_bytes)
        t2 = qm.choose_tiles(m, r, n, w2p, sms, qlib.qmm_smem_bytes)
        used = [t._asdict(), t1._asdict(), t2._asdict()]
        priced = [point.config["tiles"], *sp.config["tiles"]]
        mirror = [(lr.smem_bytes, lib.lrmm_smem_bytes, tuple(t))] + [
            (qm.smem_bytes, qlib.qmm_smem_bytes,
             (*tt[:3], int(p), tt.cluster, tt.kslice))
            for tt, p in ((t1, w1p), (t2, w2p))]
    check(failures, priced == used, f"dse: the model priced {priced} for "
          f"{key}, the launches use {used}")
    for py, c, a in mirror:
        check(failures, py(*a) == c(*a), f"dse: smem_bytes{a} is {py(*a)} "
              f"in Python, {c(*a)} in the library")
    row["pred"] = point.latency_s
    return row


def dse_phase(torch, cfg, reqs, shaped, quality, failures):
    """The paper's §VII loop on the card, on the compression phase's shaped
    weights: `dse_candidates` compressed on the card, each scored by the
    calibration's greedy agreement with the uncompressed model (ratio and
    NOps into its meta); `co_design(platform="h100")` at each of
    DSE_BATCHES, its front printed; every distinct launch of the
    candidates' layers at those batches beside the model (`model_row`:
    phase 2's row, which compared it with its plain version and timed it;
    its partition the one priced, the shared-memory mirrors the
    library's), LAUNCH_S measured, the rank correlation of predicted and
    measured linear latency over the candidates and fig11's reduction of
    ITERA against each quant-only plan, measured as the sum of the
    layers' graph-replayed launches; then each front's highest-quality and fastest point, and that of
    the ITERA plans' own front at the first batch, deployed:
    from_design_point -> JSON -> load -> InferenceEngine.build, the 16
    requests served captured with launches a step by kernel, rank and
    (K, N) checked. Returns ({label: engine} for parity, {path: launches}
    of the deployed serves)."""
    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.api.plan import CompressionPlan
    from repro_torch.core.compress import compress_params
    from repro_torch.hw import dse
    from repro_torch.hw import h100_model as hm
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    cands = dse_candidates(shaped)
    qual = {}
    build.reset_launches()          # the candidates' calibration starts
    for plan in cands:
        t0 = time.perf_counter()
        cp, rep = compress_params(shaped, plan)
        plan.meta.update(ratio=rep.compression_ratio,
                         nops=float(rep.nops_per_row))
        qual[plan.label] = quality(cp)
        del cp
        print(f"[dse] {plan.label}: agreement {qual[plan.label]:.5f}, ratio "
              f"{rep.compression_ratio:.3f}x, NOps "
              f"{rep.nops_per_row / 1e6:.3f}M/row (compressed and scored "
              f"in {time.perf_counter() - t0:.1f} s)")
    check_compared(failures, "dse calibration")
    shapes = {p.label: dse.layer_shapes_from_plan(p, shaped) for p in cands}
    fronts = {}
    for bm in DSE_BATCHES:
        front = dse.co_design(cands, lambda p: qual[p.label],
                              lambda p: shapes[p.label], batch_m=bm,
                              platform="h100")
        print(f"[dse] Pareto front at batch_m {bm} (H100 model, LAUNCH_S "
              f"{hm.LAUNCH_S * 1e6:.2f} us):")
        for dp in front:
            print(f"  {dp.label}: agreement {dp.quality:.5f}, predicted "
                  f"{dp.latency * 1e6:.2f} us, ratio "
                  f"{dp.compression_ratio:.3f}x")
        check(failures, bool(front), f"dse: empty front at batch_m {bm}")
        check(failures, all(dp.plan is not None for dp in front),
              f"dse: a point of the batch_m {bm} front has no plan")
        fronts[bm] = front

    # the model against the card: phase 2's rows, the graph replay the
    # yardstick (a captured serve runs its launches so, and LAUNCH_S is
    # taken from it), the timer's L2-flushed launch beside it
    per_launch = TIMED["quant_matmul", 8, 512, 512, True]["graph_ms"] * 1e-3
    launch_s = per_launch - hm.dense_engine(8, 512, 512, weight_wl=4,
                                            launch_s=0.0).latency_s
    print(f"[dse] LAUNCH_S measured {launch_s * 1e6:.3f} us (quant_matmul M "
          f"8 K 512 -> N 512 packed, {per_launch * 1e6:.3f} us a launch in "
          f"a graph of {GRAPH_LAUNCHES}, less its modeled max(compute, "
          f"memory)); the model's constant {hm.LAUNCH_S * 1e6:.3f} us")
    rows = {}
    print("[dse] launch | predicted us (LAUNCH_S 0) | measured us: graph, "
          "timer | predicted/measured: graph, timer")
    for bm in DSE_BATCHES:
        keys = {}
        for p in cands:
            keys.update(_launch_keys(shapes[p.label], bm))
        for key, (engine, wl) in sorted(keys.items(), key=str):
            check(failures, key in TIMED, f"dse: phase 2 did not compare "
                  f"and time {key}")
            if key not in TIMED:
                continue
            row = rows[key] = model_row(key, engine, wl, failures)
            print(f"  {key} | {row['pred'] * 1e6:.2f} "
                  f"({row['pred0'] * 1e6:.2f}) | {row['graph_ms'] * 1e3:.2f}"
                  f", {row['ms'] * 1e3:.2f} | "
                  f"{row['pred'] / (row['graph_ms'] * 1e-3):.3f}, "
                  f"{row['pred'] / (row['ms'] * 1e-3):.3f}")
            if "single" in row:
                print(f"  single engine at {key[1:5]} | "
                      f"{row['single'][0] * 1e6:.2f} "
                      f"({row['single'][1] * 1e6:.2f}) | through ops "
                      f"{row['ops_ms']['single'] * 1e3:.2f}")
    if not all(k in rows for bm in DSE_BATCHES for p in cands
               for k in _launch_keys(shapes[p.label], bm)):
        return {}, {}
    # each low-rank layer shape: the model's engine against the card's
    print("[dse] engine choice: layer | model's (all three engines) vs the "
          "card's fastest through ops (us: baseline / single / cascade)")
    seen = set()
    for p in cands:
        for l in shapes[p.label]:
            for bm in DSE_BATCHES:
                if l.rank is None or (bm, l.k, l.n, l.rank, l.wl) in seen:
                    continue
                seen.add((bm, l.k, l.n, l.rank, l.wl))
                (ck, _), = _launch_keys([l], bm).items()
                (bk, _), = _launch_keys(
                    [dataclasses.replace(l, rank=None)], bm).items()
                meas = {**TIMED[bk]["ops_ms"], **TIMED[ck]["ops_ms"]}
                model = hm.best_point(bm, l.k, l.n, l.rank, weight_wl=l.wl)
                print(f"  M {bm} K {l.k} N {l.n} R {l.rank} W{l.wl}: model "
                      f"{model.kind}, card {min(meas, key=meas.get)} ("
                      + " / ".join(f"{meas[e] * 1e3:.2f}" for e in
                                   ("baseline", "single", "cascade"))
                      + ")")
    # whole plans: predicted and measured linear latency, the sum over
    # the plan's layers of their launches' graph (and timer) times
    for bm in DSE_BATCHES:
        pred, pred0, graph, timed = {}, {}, {}, {}
        for p in cands:
            ks = [next(iter(_launch_keys([l], bm))) for l in shapes[p.label]]
            pred[p.label] = sum(rows[k]["pred"] for k in ks)
            pred0[p.label] = sum(rows[k]["pred0"] for k in ks)
            graph[p.label] = sum(rows[k]["graph_ms"] * 1e-3 for k in ks)
            timed[p.label] = sum(rows[k]["ms"] * 1e-3 for k in ks)
            priced, _ = dse.total_latency_h100(
                shapes[p.label], bm,
                engines=tuple(p.meta["engines_allowed"]))
            check(failures, abs(priced - pred[p.label]) <= 1e-9 * priced,
                  f"dse: {p.label} priced {priced} by co_design, "
                  f"{pred[p.label]} by its launches")
        labels = [p.label for p in cands]
        print(f"[dse] batch_m {bm}: plan | agreement, predicted us "
              f"(LAUNCH_S 0), measured us (its layers' launches summed: "
              f"graph, timer)")
        for lb in labels:
            print(f"  {lb}: {qual[lb]:.5f}, {pred[lb] * 1e6:.1f} "
                  f"({pred0[lb] * 1e6:.1f}), {graph[lb] * 1e6:.1f}, "
                  f"{timed[lb] * 1e6:.1f}")

        def rho(a, b):
            return spearman([a[x] for x in labels], [b[x] for x in labels])

        print(f"[dse] batch_m {bm}: rank correlation over the {len(labels)} "
              f"candidates, predicted vs measured (graph): "
              f"{rho(pred, graph):.3f} (LAUNCH_S 0: {rho(pred0, graph):.3f}"
              f"; against the timer: {rho(pred, timed):.3f})")
        itera = [x for x in labels if x.startswith("itera")]
        for q in (x for x in labels if x.startswith("quant")):
            ok = [x for x in itera if qual[x] >= qual[q] - 0.01]
            if not ok:
                print(f"  fig11 vs {q}: no ITERA plan within 0.01 of its "
                      f"agreement")
                continue
            ip, ig, it = (min(ok, key=d.get) for d in (pred, graph, timed))
            print(f"  fig11 vs {q}: predicted {ip} "
                  f"{100 * (1 - pred[ip] / pred[q]):.1f}%, measured (graph) "
                  f"{ig} {100 * (1 - graph[ig] / graph[q]):.1f}% (timer: {it}"
                  f" {100 * (1 - timed[it] / timed[q]):.1f}%) latency "
                  f"reduction (the paper: 12.1..41.1%)")
    # deploy: each front's highest-quality and fastest point, and the
    # highest-quality point of the ITERA plans' own front at the first
    # batch, so a low-rank winner goes through the same loop
    picks = {}
    for front in fronts.values():
        for dp in (front[-1], front[0]) if front else ():
            picks.setdefault(dp.label, dp)
    lowrank = dse.co_design([p for p in cands if p.label.startswith("itera")],
                            lambda p: qual[p.label],
                            lambda p: shapes[p.label],
                            batch_m=DSE_BATCHES[0], platform="h100")
    check(failures, bool(lowrank), "dse: empty front of the ITERA plans")
    if lowrank:
        picks.setdefault(lowrank[-1].label, lowrank[-1])
    out = ROOT / "build" / "dse"
    out.mkdir(parents=True, exist_ok=True)
    sp = SamplingParams(max_tokens=32)
    deployed, launches = {}, {}
    for i, (label, dp) in enumerate(picks.items()):
        plan = CompressionPlan.from_design_point(dp)
        path = out / f"{label}.json"
        plan.save(str(path))
        loaded = CompressionPlan.load(str(path))
        check(failures, loaded.to_dict() == plan.to_dict(),
              f"dse: {label}'s plan changed in its JSON round trip")
        e = InferenceEngine.build(cfg, loaded, params=shaped, device="cuda",
                                  max_batch=8, block_size=16)
        per_rank = ranks_per_step(cfg, e.plan)
        per_shape = quant_per_step(cfg, e.plan, shaped)
        print(f"[dse] deployed {path.name}: {e.plan.summary()}; launches a "
              f"step: lowrank_qmm by rank {per_rank}, quant_matmul by (K, N) "
              f"{per_shape}")
        e.serve(reqs[:2], SamplingParams(max_tokens=2))     # warm-up
        torch.cuda.synchronize()
        build.reset_launches()              # the deployed serve starts
        r = serve_checked(torch, e, "kv16", reqs, sp, {}, failures)
        launches[f"dse {i}"] = dict(build.LAUNCHES)   # ... ends here
        check_plan_launches(failures, f"dse {label}", r,
                            launches[f"dse {i}"], dict(build.LAUNCH_RANKS),
                            per_rank, cfg.num_layers, per_shape)
        deployed[f"dse {i}"] = e
    print(f"[dse] phase: {time.perf_counter() - t_phase:.1f} s")
    return deployed, launches


RECT = (8, 128, 100)     # rows, prompt tokens, and the cut to 100 tokens


def first_difference(torch, eng, prompts, a, b):
    """(row, position, top-2 margin) of the first token where outputs `a`
    and `b` (rows of tokens) differ, the margin from the logits `eng`
    computes after that row's prompt and its common tokens; None where
    they agree."""
    import numpy as np

    for i, (x, y) in enumerate(zip(a, b)):
        if not np.array_equal(x, y):
            p = int(np.argmax(x != y))
            lg = last_logits(torch, eng, np.concatenate([prompts[i], x[:p]]))
            top = torch.topk(lg, 2).values
            return i, p, float(top[0] - top[1])
    return None


def rectangular_phase(torch, cfg, eng, eng8, qeng, failures):
    """`InferenceEngine.generate` on a rectangular batch: the RECT prompts
    of the seeded Markov task through one prefill (a 128-token bucket,
    M 1024 for every layer linear, the lm head at the last position only)
    and 31 lockstep decode steps (M 8) over a contiguous KV cache, 32
    tokens a row.

    Mixed plan, fp32 and int8 KV, greedy: launches exactly 72 lowrank_qmm
    and 1 quant_matmul a pass, no paged attention; the tokens of `serve`
    on the same prompts (a difference is allowed only as the one flipped
    position, margin < 0.1, that tests/test_torch_forward.py allows); the
    100-token cut (bucket 128, last_pos 99) as an unbucketed engine
    gives. The quant-only plan: 73 quant_matmul launches a pass, by (K, N),
    and its serve's tokens. Sampled (temperature 0.8, top-k 50, top-p 0.9,
    seed 7): the same tokens twice, and serve's. A sampled stop run (an
    eos id and a stop sequence taken from two rows of that run): each row
    is `match_stop_host` of its untruncated run. Every lowrank_qmm launch
    on a code path phase 2 compared. (Its timing is the graphs phase's.)
    Returns the launches of the generate runs."""
    import numpy as np

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.kernels import build
    from repro_torch.runtime.sampling import match_stop_host

    rows, seq, cut_len = RECT
    prompts = markov_prompts(cfg)
    cut = np.ascontiguousarray(prompts[:, :cut_len])
    n = 32
    sp = SamplingParams(max_tokens=n)
    per_pass = sum(lowrank_launch_shapes(cfg).values())
    launches = collections.Counter()

    def run(e, p, s, label):
        """generate, its launches added to the phase's and checked against
        the compared code paths."""
        build.reset_launches()
        res = e.generate(p, s)
        torch.cuda.synchronize()
        launches.update(build.LAUNCHES)
        check_compared(failures, f"rectangular {label}")
        return res, dict(build.LAUNCHES)

    def same_as_serve(e, res, s, label):
        srv = e.serve(list(prompts), s)
        torch.cuda.synchronize()
        diff = first_difference(torch, e, prompts, res.tokens, srv.outputs)
        if diff is None:
            print(f"[rectangular] {label}: generate == serve")
            return srv
        n_rows = sum(not np.array_equal(x, y)
                     for x, y in zip(res.tokens, srv.outputs))
        i, p, margin = diff
        print(f"[rectangular] {label}: generate and serve differ in "
              f"{n_rows} row(s), first at row {i} position {p}, top-2 "
              f"margin {margin:.3e}")
        check(failures, n_rows <= 1 and margin < 0.1,
              f"rectangular {label}: generate differs from serve beyond one "
              f"flipped position at a margin < 0.1")
        return srv

    eng.generate(cut, SamplingParams(max_tokens=2))          # warm-up
    torch.cuda.synchronize()
    greedy = {}
    for kv, e in (("kv16", eng), ("int8 KV", eng8)):
        res, counts = run(e, prompts, sp, kv)
        print(f"[rectangular] {e.plan.label} {kv}: {rows} x {seq} prompt "
              f"tokens, {res.tokens.size} tokens in {res.seconds:.3f} s = "
              f"{res.tokens_per_second:.1f} tok/s; launches {counts}")
        check(failures, counts == {"lowrank_qmm": per_pass * n,
                                   "quant_matmul": n},
              f"rectangular {kv}: launches {counts}, expected "
              f"{per_pass} lowrank_qmm and 1 quant_matmul a pass x {n}")
        check(failures, res.tokens.shape == (rows, n) and bool(
            ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
            f"rectangular {kv}: tokens {res.tokens.shape} or out of range")
        same_as_serve(e, res, sp, f"{e.plan.label} {kv}")
        bucketed, _ = run(e, cut, sp, f"{kv} cut")
        flat = InferenceEngine(e.cfg, e.params, device=e.device, plan=e.plan,
                               bucket_prompts=False)
        unbucketed, _ = run(flat, cut, sp, f"{kv} cut unbucketed")
        check(failures, np.array_equal(bucketed.tokens, unbucketed.tokens),
              f"rectangular {kv}: the {cut_len}-token cut's bucketed tokens "
              f"differ from the unbucketed engine's")
        greedy[kv] = res

    res, counts = run(qeng, prompts, sp, "quant-only")
    shapes = {key[1:]: c for key, c in build.LAUNCH_SHAPES.items()
              if key[0] == "quant_matmul"}
    print(f"[rectangular] {qeng.plan.label} kv16: launches {counts}; "
          f"quant_matmul by (K, N) {shapes}")
    check(failures, set(counts) == {"quant_matmul"},
          f"rectangular quant-only: launches {counts}")
    for (k, nn), per in quant_launch_shapes(cfg).items():
        check(failures, shapes.get((k, nn), 0) == per * n,
              f"rectangular quant-only K{k}->N{nn}: {shapes.get((k, nn), 0)} "
              f"launches, expected {per} a pass x {n}")
    check(failures, sum(shapes.values()) == counts.get("quant_matmul"),
          "rectangular quant-only: quant_matmul launches outside the plan")
    same_as_serve(qeng, res, sp, f"{qeng.plan.label} kv16")

    sps = SamplingParams(max_tokens=n, temperature=0.8, top_k=50, top_p=0.9,
                         seed=7)
    first, _ = run(eng, prompts, sps, "sampled")
    again, _ = run(eng, prompts, sps, "sampled again")
    check(failures, np.array_equal(first.tokens, again.tokens),
          "rectangular sampled: a second seeded generate differs")
    check(failures, not np.array_equal(first.tokens, greedy["kv16"].tokens),
          "rectangular sampled: the sampled tokens are the greedy ones")
    srv = eng.serve(list(prompts), sps)
    check(failures, all(np.array_equal(a, b)
                        for a, b in zip(first.tokens, srv.outputs)),
          "rectangular sampled: generate differs from serve")

    # stops taken from two rows of the sampled run (random weights' greedy
    # rows repeat one token, which would stop every row at once)
    out = first.tokens
    stop = dataclasses.replace(sps, eos_id=int(out[1, 8]),
                               stop=((int(out[5, 20]), int(out[5, 21])),))
    st, _ = run(eng, prompts, stop, "stops")
    keeps = []
    for i in range(rows):
        keep = match_stop_host(out[i], stop.eos_id, stop.stop, n)
        keeps.append(keep)
        check(failures, np.array_equal(st.tokens[i], np.r_[
            out[i, :keep], np.zeros(n - keep, np.int32)]),
            f"rectangular stops: row {i} is not match_stop_host of its run")
    check(failures, keeps[1] < n and keeps[5] < n,
          f"rectangular stops: rows 1 and 5 kept {keeps[1]}, {keeps[5]}")
    print(f"[rectangular] stops (eos {stop.eos_id}, stop {stop.stop}): "
          f"lengths {keeps}")
    return dict(launches)


def markov_prompts(cfg):
    """The rectangular phase's RECT prompts of the seeded Markov task."""
    from repro_torch.data.pipeline import MarkovTask

    rows, seq, _ = RECT
    return MarkovTask(cfg.vocab_size, seed=0).batch(0, rows, seq)[
        "tokens"].numpy()


def launch_counts():
    """Every launch counter, as plain dicts."""
    from repro_torch.kernels import build

    return (dict(build.LAUNCHES), dict(build.LAUNCH_SHAPES),
            dict(build.LAUNCH_RANKS))


GRAPH_ROUNDS = 1         # interleaved eager / captured timing rounds
# the graphs phase's serves: the workload's first requests, and the new
# tokens of its serves and generates
GRAPHS_REQS, GRAPHS_TOKENS = 8, 16


def graphs_phase(torch, cfg, engines, reqs, failures):
    """Each step a CUDA-graph replay (the engines' default) against the
    same step run eagerly on the card (`cuda_graphs=False`), for each of
    `engines` ({label: captured engine}: the mixed plan with fp32 and int8
    KV, the quant-only plan): greedy, sampled (temperature 0.8, top-k 50,
    top-p 0.9, seed 7), stopped (eos ids and stop sequences from the
    sampled run) and speculative (DraftSpec(**SPEC)) serves of the first
    GRAPHS_REQS requests, and greedy and sampled generates of the RECT
    prompts, GRAPHS_TOKENS tokens each: identical tokens and identical
    launch counters, every lowrank_qmm launch on a code path phase 2
    compared; each case's seconds (both runs) printed. Prints the graphs
    captured, their capture seconds and the device bytes they reserved. Then GRAPH_ROUNDS interleaved rounds (eager,
    captured; captured, eager; ...) of the mixed kv16 plan's serve of
    those requests and
    generate of the RECT prompts (a generate of one token for its
    prefill): median, min and max of TPOT p50, TTFT p50 and tok/s, and of
    prefill ms and decode ms a step; and one eager and one captured serve
    and generate under torch.profiler (the card-busy share)."""
    import numpy as np

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.kernels import build
    from repro_torch.runtime.scheduler import Request
    from repro_torch.runtime.speculation import DraftSpec

    prompts = markov_prompts(cfg)
    reqs = reqs[:GRAPHS_REQS]
    n = GRAPHS_TOKENS
    sp = SamplingParams(max_tokens=n)
    sps = SamplingParams(max_tokens=n, temperature=0.8, top_k=50, top_p=0.9,
                         seed=7)

    def twin(e, **kw):
        return InferenceEngine(e.cfg, e.params, device=e.device, plan=e.plan,
                               max_batch=8, block_size=16, **kw)

    def run(fn):
        build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, launch_counts()

    def outputs(res):
        return (list(res.outputs) if hasattr(res, "outputs")
                else list(res.tokens))

    captured = []
    for label, eng in engines.items():
        eager = twin(eng, cuda_graphs=False)
        spec = {g: twin(eng, speculate=DraftSpec(**SPEC), cuda_graphs=g)
                for g in (True, False)}
        captured += [eng, spec[True]]
        sampled = eng.serve(reqs, sps).outputs
        stops = {1: {"eos_id": int(sampled[1][8])},
                 6: {"eos_id": int(sampled[6][12])},
                 7: {"stop": ((int(sampled[7][5]),
                               int(sampled[7][6])),)}}
        stopped = [Request(tokens=t, **stops.get(i, {}))
                   for i, t in enumerate(reqs)]
        # what -> (whether the speculative engines run it, the run)
        cases = {"greedy serve": (False, lambda e: e.serve(reqs, sp)),
                 "sampled serve": (False, lambda e: e.serve(reqs, sps)),
                 "stopped serve": (False, lambda e: e.serve(stopped, sps)),
                 "speculative serve": (True, lambda e: e.serve(reqs, sp)),
                 "greedy generate": (False,
                                     lambda e: e.generate(prompts, sp)),
                 "sampled generate": (False,
                                      lambda e: e.generate(prompts, sps))}
        for what, (speculative, fn) in cases.items():
            t0 = time.perf_counter()
            pair = (spec[True], spec[False]) if speculative else (eng, eager)
            (got, c_got), (want, c_want) = (run(lambda: fn(e)) for e in pair)
            check_compared(failures, f"graphs {label} {what}")
            same = all(np.array_equal(a, b) for a, b in
                       zip(outputs(got), outputs(want)))
            check(failures, same and len(outputs(got)) == len(outputs(want)),
                  f"graphs {label} {what}: captured tokens differ from eager")
            check(failures, c_got == c_want,
                  f"graphs {label} {what}: captured launches {c_got[0]} "
                  f"differ from eager {c_want[0]}")
            pace = (f"TPOT p50 {got.tpot_p50 * 1e3:.2f} ms (eager "
                    f"{want.tpot_p50 * 1e3:.2f})" if hasattr(got, "tpot_p50")
                    else f"{got.seconds * 1e3:.1f} ms (eager "
                    f"{want.seconds * 1e3:.1f})")
            print(f"[graphs] {label} {what}: captured == eager: {same}; "
                  f"{pace}; launches {c_got[0]}; "
                  f"{time.perf_counter() - t0:.1f} s")
    st = {"graphs": 0, "capture_seconds": 0.0, "pool_bytes": 0}
    for e in captured:
        for k, v in e.graph_stats().items():
            st[k] += v
    print(f"[graphs] {st['graphs']} graphs held, captured in "
          f"{st['capture_seconds']:.2f} s, reserving "
          f"{st['pool_bytes'] / 2**20:.1f} MiB; card memory reserved "
          f"{torch.cuda.memory_stats()['reserved_bytes.all.current'] / 2**20:.1f}"
          f" MiB")
    check(failures, st["graphs"] > 0, "graphs: no step graph was captured")

    # timing: eager and captured in turns, on one card within one call
    eng = engines["mixed kv16"]
    pair = {"captured": eng, "eager": twin(eng, cuda_graphs=False)}
    one = SamplingParams(max_tokens=1)
    for e in pair.values():                 # warm-up: builds and captures
        e.serve(reqs, sp)
        e.generate(prompts, sp)
        e.generate(prompts, one)
    times = collections.defaultdict(lambda: collections.defaultdict(list))
    for i in range(GRAPH_ROUNDS):
        order = list(pair) if i % 2 else list(pair)[::-1]
        for mode in order:
            e = pair[mode]
            srv = e.serve(reqs, sp)
            pre = e.generate(prompts, one)
            gen = e.generate(prompts, sp)
            torch.cuda.synchronize()
            t = times[mode]
            t["serve TPOT p50 ms"].append(srv.tpot_p50 * 1e3)
            t["serve TTFT p50 ms"].append(srv.ttft_p50 * 1e3)
            t["serve tok/s"].append(srv.tokens_per_second)
            t["generate prefill ms"].append(pre.seconds * 1e3)
            t["generate decode ms a step"].append(
                (gen.seconds - pre.seconds) * 1e3 / (n - 1))
            t["generate tok/s"].append(gen.tokens_per_second)
    rows, seq, _ = RECT
    print(f"[graphs] timing on {card_line()}, host clock: {eng.plan.label} "
          f"kv16, serve of the {len(reqs)} requests and generate of {rows} "
          f"x {seq} prompts, {n} tokens each, {GRAPH_ROUNDS} interleaved "
          f"rounds")
    for what in times["eager"]:
        for mode in ("eager", "captured"):
            xs = times[mode][what]
            print(f"[graphs] timing {mode} {what}: median "
                  f"{float(np.median(xs)):.3f} (min {min(xs):.3f}, max "
                  f"{max(xs):.3f})")
    for mode, e in pair.items():
        profile_run(torch, lambda: e.serve(reqs, sp).steps,
                    f"{mode} mixed kv16 serve")
        profile_run(torch, lambda: (e.generate(prompts, sp), n)[1],
                    f"{mode} mixed kv16 generate")


# ------------------------------------------------------------------ tp --

TP_SHORT = (16, 29, 47, 64)      # the mixed plan's card == CPU requests
TP_SVD = dict(method="svd", weight_wl=8, rank_fraction=0.75,
              include=r"/(wq|wk|wv|gate|up)$")   # N-sites only
TP_DRAFT = dict(k=4, rank_fraction=0.25)
TP_ROUNDS = 1            # A B B A rounds of the tp 1 TPOT comparison


def count_all_reduces():
    """Wrap `torch.distributed.all_reduce` (which
    `runtime.shardctx.psum_tp` calls) with a counter; returns the counter
    and a function that puts the original back."""
    import torch.distributed as dist

    reduce = dist.all_reduce
    calls = collections.Counter()

    def counted(*args, **kwargs):
        calls["all_reduce"] += 1
        return reduce(*args, **kwargs)

    dist.all_reduce = counted
    return calls, lambda: setattr(dist, "all_reduce", reduce)


def tp_rank(mesh, cases):
    """One rank process of the tp phase's tp 2 meshes: each case's engine
    built on this rank, eagerly, from seed 0 (compressed here under
    "plan") or from a checkpoint of compressed weights, and its requests
    served. Returns rank 0's tokens, launch counters, TPOT p50 and wall
    ms a step by case. The card's ranks and the CPU's run at once: a
    card's rank takes one intra-op thread, a CPU's rank half of the rest
    of the host's (the spawning process's count)."""
    import torch

    from repro_torch import bridge
    from repro_torch.api.engine import InferenceEngine
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_params

    threads = torch.get_num_threads()
    torch.set_num_threads(1 if mesh.device.type == "cuda"
                          else max(1, (threads - 2) // 2))
    # the all-reduces a serve makes (this process ends with the mesh)
    calls, _ = count_all_reduces()
    out = {}
    for name, c in cases.items():
        if c["weights"] == "seed":
            params = init_params(c["cfg"], seed=0, device=mesh.device)
            plan = quant_plan(params) if c.get("plan") == "quant" else None
        else:
            params = bridge.load_checkpoint(c["weights"], device=mesh.device)
            plan = None
        eng = InferenceEngine.build(c["cfg"], plan, params=params, mesh=mesh,
                                    cuda_graphs=False, max_batch=8,
                                    block_size=16,
                                    speculate=c.get("speculate"))
        build.reset_launches()
        calls.clear()
        res = eng.serve(c["prompts"], c["sampling"])
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        out[name] = dict(outputs=[o.copy() for o in res.outputs],
                         counts=launch_counts(), tpot=res.tpot_p50,
                         step_ms=res.seconds / res.steps * 1e3,
                         steps=res.steps, drafted=res.drafted,
                         spec_rounds=res.spec_rounds,
                         all_reduces=calls["all_reduce"])
    return out


def tp_phase(torch, failures, engines=None):
    """Tensor-parallel serving of opus-mt full() (see the module's
    docstring, "tp"). `engines`: {"kv16", "kv8"} solo captured engines of
    the mixed plan (built here when None). Returns the launches of its
    runs on the card (tp 1 in this process, rank 0 of the tp 2 runs)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.compress import CompressionConfig, shape_spectra
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_serving_mesh, spawn
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.speculation import DraftSpec

    cfg = get_config("opus-mt")
    if engines is None:
        eng = build_engine(torch, cfg, mixed_plan)
        engines = {"kv16": eng, "kv8": InferenceEngine(
            dataclasses.replace(cfg, kv_cache_bits=8), eng.params,
            device=eng.device, plan=eng.plan, max_batch=8, block_size=16)}
    reqs = workload(cfg.vocab_size)[:GRAPHS_REQS]
    sp = SamplingParams(max_tokens=GRAPHS_TOKENS)
    launches = collections.Counter()
    card = card_line()

    def run(e, prompts=reqs):
        build.reset_launches()
        res = e.serve(prompts, sp)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches.update(counts[0])
        return res, counts

    # ---- tp 1 over NCCL, in this process, captured ----------------------
    t_tp1 = time.perf_counter()
    mesh = make_serving_mesh(1)
    calls, restore = count_all_reduces()
    two_l = 2 * cfg.num_layers
    try:
        for label, solo in engines.items():
            tp1 = InferenceEngine(solo.cfg, solo.params, device=solo.device,
                                  plan=solo.plan, mesh=mesh, max_batch=8,
                                  block_size=16)
            solo.serve(reqs[:2], SamplingParams(max_tokens=2))
            calls.clear()
            # warm-up: builds, captures (each step graph runs its step once
            # eagerly, then captures it)
            tp1.serve(reqs[:2], SamplingParams(max_tokens=2))
            (got, c_got), (want, c_want) = run(tp1), run(solo)
            captured = calls["all_reduce"]
            check_compared(failures, f"tp 1 {label}")
            same = all(np.array_equal(a, b)
                       for a, b in zip(got.outputs, want.outputs))
            check(failures, same, f"tp 1 nccl {label}: tokens differ from "
                  f"the solo captured engine's")
            check(failures, c_got == c_want and got.steps == want.steps,
                  f"tp 1 nccl {label}: launches {c_got[0]} over {got.steps} "
                  f"steps, solo {c_want[0]} over {want.steps}")
            graphs = tp1.graph_stats()["graphs"]
            check(failures, graphs > 0, f"tp 1 nccl {label}: no step graph "
                  f"was captured")
            check(failures, captured > 0 and captured % two_l == 0,
                  f"tp 1 nccl {label}: {captured} all_reduce calls while "
                  f"{graphs} step graphs were made, not a multiple of 2L "
                  f"= {two_l}")
            print(f"[tp] tp 1 nccl {label}: {captured} all_reduce calls "
                  f"({captured / two_l:g} x 2L) while {graphs} step graphs "
                  f"were warmed up and captured, none on replays")
            eager = InferenceEngine(solo.cfg, solo.params, device=solo.device,
                                    plan=solo.plan, mesh=mesh,
                                    cuda_graphs=False, max_batch=8,
                                    block_size=16)
            calls.clear()
            res, c_eager = run(eager)
            same_eager = all(np.array_equal(a, b)
                             for a, b in zip(res.outputs, want.outputs))
            check(failures, same_eager and c_eager == c_want,
                  f"tp 1 nccl eager {label}: tokens or launches differ from "
                  f"the solo captured engine's")
            check(failures, calls["all_reduce"] == two_l * res.steps,
                  f"tp 1 nccl eager {label}: {calls['all_reduce']} "
                  f"all_reduce calls over {res.steps} steps, not 2L = "
                  f"{two_l} a step")
            print(f"[tp] tp 1 nccl eager {label}: == solo: {same_eager}; "
                  f"{calls['all_reduce']} all_reduce calls over {res.steps} "
                  f"steps = {calls['all_reduce'] / res.steps:g} a step")
            del eager
            tpot = collections.defaultdict(list)
            for i in range(TP_ROUNDS):
                pair = (("solo", solo), ("tp 1", tp1))
                for name, e in (pair if i % 2 else pair[::-1]) + (
                        pair[::-1] if i % 2 else pair):
                    tpot[name].append(run(e)[0].tpot_p50 * 1e3)
            med = {k: float(np.median(v)) for k, v in tpot.items()}
            print(f"[tp] tp 1 nccl {label}: captured == solo: {same}; "
                  f"launches {c_got[0]} over {got.steps} steps; {graphs} "
                  f"graphs; TPOT p50 {med['tp 1']:.3f} ms (solo "
                  f"{med['solo']:.3f} ms, ratio "
                  f"{med['tp 1'] / med['solo']:.3f}; {TP_ROUNDS} A B B A "
                  f"rounds of {len(reqs)} requests x {sp.max_tokens} "
                  f"tokens) on {card}")
            rows = (profile_run(torch, lambda: run(tp1)[0].steps,
                                f"tp 1 nccl {label} serve")
                    if label == "kv16" else None)
            if rows:
                nccl = sum(n for _, n, key in rows if "nccl" in key.lower())
                print(f"[tp] tp 1 nccl {label}: {nccl} NCCL kernels over "
                      f"{got.steps} steps = {nccl / got.steps:g} a step "
                      f"(2L = {two_l}; an all-reduce over one rank launches "
                      f"nothing)")
    finally:
        restore()
        dist.destroy_process_group()

    # ---- tp 2 over gloo: two rank processes on this card, eagerly --------
    print(f"[tp] tp 1 over NCCL: {time.perf_counter() - t_tp1:.1f} s")
    t_solo = time.perf_counter()
    rng = np.random.default_rng(1)
    short = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
             for n in TP_SHORT]
    sp8 = SamplingParams(max_tokens=8)
    out_dir = ROOT / "build" / "tp"
    mixed_dir = str(out_dir / "mixed")
    ckpt.save(mixed_dir, 0, engines["kv16"].params, keep=1)
    cases, want = {}, {}
    for kv in (16, 8):
        cases[f"mixed kv{kv}"] = dict(
            cfg=dataclasses.replace(cfg, kv_cache_bits=kv),
            weights=mixed_dir, prompts=short, sampling=sp8)
    dense = InferenceEngine.build(cfg, None, seed=0, device="cuda",
                                  max_batch=8, block_size=16)
    want["dense fp32"] = run(dense)[0].outputs
    cases["dense fp32"] = dict(cfg=cfg, weights="seed", prompts=reqs,
                               sampling=sp)
    # quant-only: compressed in each rank on the card; the CPU's ranks
    # read the solo engine's compression of the same weights
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bparams = init_params(bcfg, seed=0, device="cuda")
    bsolo = InferenceEngine.build(bcfg, quant_plan(bparams), params=bparams,
                                  device="cuda", max_batch=8, block_size=16)
    del bparams
    build.reset_launches()
    solo_short = {"bf16 quant-only": bsolo.serve(short, sp8).outputs}
    bf16_dir = str(out_dir / "bf16-quant")
    ckpt.save(bf16_dir, 0, bsolo.params, keep=1)
    del bsolo
    cases["bf16 quant-only"] = dict(cfg=bcfg, weights="seed", plan="quant",
                                    prompts=short, sampling=sp8)
    cpu_cases = {name: c for name, c in cases.items()
                 if name.startswith("mixed")}
    cpu_cases["bf16 quant-only"] = dict(cases["bf16 quant-only"],
                                        weights=bf16_dir, plan=None)
    # shaped weights, as the reference's TP speculation test: drafts get
    # accepted, so rounds emit several tokens
    svd = InferenceEngine.build(cfg, CompressionConfig(**TP_SVD),
                                params=shape_spectra(init_params(
                                    cfg, seed=0, device="cuda"), alpha=3.0),
                                device="cuda", max_batch=8, block_size=16)
    want["svd speculative"] = run(svd)[0].outputs
    svd_dir = str(out_dir / "svd")
    ckpt.save(svd_dir, 0, svd.params, keep=1)
    cases["svd speculative"] = dict(cfg=cfg, weights=svd_dir, prompts=reqs,
                                    sampling=sp,
                                    speculate=DraftSpec(**TP_DRAFT))
    print(f"[tp] solo engines and checkpoints: "
          f"{time.perf_counter() - t_solo:.1f} s")
    # the CPU's ranks run while the card's do (`tp_rank` shares the
    # host's threads between them)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        on_cpu = pool.submit(spawn, tp_rank, 2, cpu_cases,
                             devices=["cpu"] * 2, timeout=600)
        got = spawn(tp_rank, 2, cases, devices=["cuda:0"] * 2,
                    backend="gloo", timeout=600)
        t_card = time.perf_counter() - t0
        cpu = on_cpu.result()
    print(f"[tp] tp 2 gloo: {len(cases)} engines on one card in "
          f"{t_card:.1f} s and {len(cpu_cases)} on the CPU, at once, in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in cases:
        g = got[name]
        w = cpu[name]["outputs"] if name in cpu else want[name]
        same = len(g["outputs"]) == len(w) and all(
            np.array_equal(a, b) for a, b in zip(g["outputs"], w))
        against = "tp 2 on the CPU" if name in cpu else "the solo card engine"
        check(failures, same, f"tp 2 gloo {name}: tokens differ from "
              f"{against}'s")
        shapes = g["counts"][1]
        seen_lr = {k[1:] for k in shapes if k[0] == "lowrank_qmm"}
        seen_q = {k[1:] for k in shapes if k[0] == "quant_matmul"}
        check(failures, seen_lr <= COMPARED and seen_q <= COMPARED_QMM,
              f"tp 2 gloo {name}: launches at keys phase 2 did not compare: "
              f"{sorted(seen_lr - COMPARED)} {sorted(seen_q - COMPARED_QMM)}")
        launches.update(g["counts"][0])
        if name == "svd speculative":
            check(failures, g["drafted"] > 0, "tp 2 gloo svd speculative: "
                  "no draft token was proposed")
        per_step = g["all_reduces"] / g["steps"]
        print(f"[tp] tp 2 gloo {name}: {g['all_reduces']} all-reduces over "
              f"{g['steps']} steps ({per_step:g} a step; {g['spec_rounds']} "
              f"drafting rounds)")
        if not g["spec_rounds"]:
            check(failures, g["all_reduces"] == 2 * cfg.num_layers
                  * g["steps"], f"tp 2 gloo {name}: {per_step:g} "
                  f"all-reduces a step, not 2L = {2 * cfg.num_layers}")
        if name in solo_short:
            # compressed K-sites requantize their activations over each
            # rank's features (the reference's rule): close to the solo
            # engine, not bit-equal; measured, not gated
            a = np.concatenate(g["outputs"])
            b = np.concatenate(solo_short[name])
            print(f"[tp] tp 2 gloo {name}: {int((a == b).sum())} of {a.size}"
                  f" tokens equal the solo card engine's")
        print(f"[tp] tp 2 gloo {name}: == {against}: {same}; launches "
              f"{g['counts'][0]} over {g['steps']} steps; drafted "
              f"{g['drafted']}; gloo through the host on one card: not a TP "
              f"speed: TPOT p50 {g['tpot'] * 1e3:.2f} ms, wall "
              f"{g['step_ms']:.2f} ms a step")
    return dict(launches)


# ---------------------------------------------------------------- train --

# the failure lies between the first two checkpoints
TRAIN = dict(batch=8, seq=128, steps=60, lr=1e-3, ckpt_every=30,
             fail_at=45)
REMAT_STEPS = 12         # steps a remat setting, the first 3 untimed
# a training-size batch for the remat trade (16,384 tokens a step); its
# first 2 steps untimed
TRAIN_BIG = dict(batch=32, seq=512, steps=8)
# the train CLI: hash data, 2 microbatches, checkpoints every 3 steps, a
# failure injected at step 4, then resumed from the step-3 checkpoint
TRAIN_CLI = dict(steps=6, batch=TRAIN["batch"], seq=TRAIN["seq"],
                 microbatches=2, ckpt_every=3, fail_at=4)
TRAIN_TOL = 1e-5         # replayed steps against the first pass, relative
CARD_CPU_TOL = 1e-4      # loss and grad norm, card against the CPU


def train_flops(cfg, tokens: int, remat: bool, seq: int) -> float:
    """Least FLOPs of a train step: the forward's 2 a matmul parameter and
    token (every layer linear and the lm head; the embedding is a gather)
    plus attention's QK^T and PV over the causal half of S x S (2 S
    d_model a token and layer), three times that with the backward pass,
    four times with full remat's second forward."""
    d, f, n, v = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
    forward = 2 * (n * (4 * d * d + 2 * d * f) + d * v) \
        + n * 2 * seq * d
    return (4 if remat else 3) * forward * tokens


def run_train(torch, cfg, opt_cfg, task, steps, *, loop_kw=None,
              ckpt_dir=None, batch=TRAIN["batch"], seq=TRAIN["seq"],
              ssm_engine=None):
    """Train from init_params(seed 0) on the card with launch/train.py's
    step (or, given `ssm_engine`, launch/steps.py's `make_train_step`
    with that scan engine) on batch x seq tokens of `task`; with
    `loop_kw`, inside a ResilientLoop saving to `ckpt_dir`.
    Returns (state, [(step, loss, ms)], loop report or None)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import make_accum_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import ResilientLoop

    params = init_params(cfg, seed=0, device="cuda")
    state = {"params": params, "opt": adamw.init(params, opt_cfg)}
    if ssm_engine is None:
        step = make_accum_train_step(cfg, opt_cfg, 1)
    else:
        step = make_train_step(cfg, opt_cfg, ssm_engine=ssm_engine)
    log = []

    def step_fn(state, s):
        b = task.batch(s, batch, seq, device="cuda")
        t0 = time.perf_counter()
        p, o, m = step(state["params"], state["opt"], b)
        torch.cuda.synchronize()
        log.append((s, float(m["loss"]), (time.perf_counter() - t0) * 1e3))
        return {"params": p, "opt": o}, m

    if loop_kw is None:
        for s in range(steps):
            state, _ = step_fn(state, s)
        return state, log, None
    like = state

    def save_fn(st, s):
        ckpt.save(ckpt_dir, s, st)

    loop = ResilientLoop(step_fn, save_fn,
                         lambda: ckpt.restore(ckpt_dir, like), **loop_kw)
    save_fn(state, 0)
    state, _ = loop.run(state, 0, steps)
    return state, log, loop.report


def profile_steps(torch, cfg, opt_cfg, task, state, label, *,
                  batch=TRAIN["batch"], seq=TRAIN["seq"]) -> None:
    """Three more train steps of `state` on batch x seq tokens under
    torch.profiler (`profile_run`: the card's busy share and time by
    kernel)."""
    from repro_torch.launch.train import make_accum_train_step

    step = make_accum_train_step(cfg, opt_cfg, 1)
    batches = [task.batch(s, batch, seq, device="cuda") for s in range(3)]

    def run():
        for b in batches:
            state["params"], state["opt"], _ = step(state["params"],
                                                    state["opt"], b)
        return len(batches)

    profile_run(torch, run, label)


def train_cli_check(torch, cfg, out_dir, failures, *, arch="opus-mt",
                    smoke=False, c=TRAIN_CLI, tag="train") -> None:
    """launch/train.py's `main` for `arch` (`cfg`, at full width unless
    `smoke`) on its default device (the card), as a user runs it: c's
    steps of c's batch x seq tokens of `hash_batch` data in c's
    microbatches, a failure injected and restored from a
    checkpoint; then the last checkpoint removed and the run continued
    with --resume from the one before. Both runs' losses are held to
    make_accum_train_step's on the same initial weights and batches,
    within TRAIN_TOL relative."""
    import shutil

    import numpy as np

    from repro_torch.data.pipeline import hash_batch
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw

    batch, seq = c["batch"], c["seq"]
    ckpt_dir = out_dir / "cli"
    argv = ["--arch", arch, "--steps", str(c["steps"]),
            "--batch", str(batch), "--seq", str(seq),
            "--lr", str(TRAIN["lr"]), "--microbatches",
            str(c["microbatches"]), "--data", "hash", "--ckpt-dir",
            str(ckpt_dir), "--ckpt-every", str(c["ckpt_every"])] \
        + (["--smoke"] if smoke else [])
    t0 = time.perf_counter()
    first = train.main(argv + ["--inject-failure-at", str(c["fail_at"])])
    shutil.rmtree(ckpt_dir / f"step_{c['steps']:08d}")
    resumed = train.main(argv + ["--resume"])
    wall = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir)

    # the step's own losses: the CLI's schedule (warmup max(steps // 20, 5))
    opt_cfg = adamw.AdamWConfig(lr=TRAIN["lr"], total_steps=c["steps"],
                                warmup_steps=max(c["steps"] // 20, 5))
    step = train.make_accum_train_step(cfg, opt_cfg, c["microbatches"])
    params = init_params(cfg, seed=0, device="cuda")
    opt = adamw.init(params, opt_cfg)
    own = []
    for s in range(c["steps"]):
        params, opt, m = step(params, opt, hash_batch(
            0, s, batch, seq, cfg.vocab_size, device="cuda"))
        own.append(float(m["loss"]))
    del params, opt
    back = c["fail_at"] // c["ckpt_every"] * c["ckpt_every"]
    want = {"injected": own[:c["fail_at"]] + own[back:],
            "resumed": own[back:]}
    got = {"injected": first, "resumed": resumed}
    print(f"[{tag}] CLI --arch {arch}{' --smoke' if smoke else ''} on the "
          f"card ({wall:.1f} s, {batch} x {seq}, {c['microbatches']} "
          f"microbatches, hash data): own step losses "
          + " ".join(f"{x:.6f}" for x in own))
    for name in want:
        ok = len(got[name]) == len(want[name])
        worst = max((abs(a - b) / abs(b) for a, b
                     in zip(got[name], want[name])), default=0.0)
        same = ok and got[name] == want[name]
        print(f"[{tag}] CLI {name} run: {len(got[name])} losses against "
              f"{len(want[name])}, largest relative difference "
              f"{worst:.3e}, bit-equal: {same}")
        check(failures, ok and worst <= TRAIN_TOL, f"{tag}: the {arch} "
              f"CLI's {name} run differs from the step's own losses "
              f"({len(got[name])} losses, {worst:.3e} relative)")
    check(failures, all(np.isfinite(own)), f"{tag}: a CLI loss is not "
          "finite")


FRONTEND_CLI = dict(arch="musicgen-medium", steps=4, batch=4, seq=32)


def frontend_cli_check(torch, out_dir, failures) -> None:
    """launch/train.py's `main` for a modality-frontend arch (musicgen's
    smoke config, audio: each batch lifted to rows of the seeded table,
    `runtime.prng.normal`, drawn on the run's device) for FRONTEND_CLI's
    steps on the CPU, then on the card from the CPU run's step-0
    checkpoint (`init_params` draws other weights on each device):
    finite losses, equal within CARD_CPU_TOL relative."""
    import shutil

    import numpy as np

    from repro_torch.launch import train

    c = FRONTEND_CLI
    argv = ["--arch", c["arch"], "--smoke", "--steps", str(c["steps"]),
            "--batch", str(c["batch"]), "--seq", str(c["seq"])]
    cpu_dir, card_dir = out_dir / "frontend_cpu", out_dir / "frontend"
    cpu = train.main(argv + ["--ckpt-dir", str(cpu_dir), "--device", "cpu"])
    card_dir.mkdir(parents=True, exist_ok=True)
    shutil.copytree(cpu_dir / "step_00000000", card_dir / "step_00000000")
    t0 = time.perf_counter()
    card = train.main(argv + ["--ckpt-dir", str(card_dir), "--resume"])
    wall = time.perf_counter() - t0
    for d in (cpu_dir, card_dir):
        shutil.rmtree(d)
    worst = max((abs(a - b) / abs(b) for a, b in zip(card, cpu)),
                default=0.0)
    print(f"[train] CLI {c['arch']} --smoke (audio frontend, lifted "
          f"embeddings) on the card from the CPU run's step-0 checkpoint in "
          f"{wall:.1f} s: losses " + " ".join(f"{x:.6f}" for x in card)
          + f"; the CPU's within {worst:.3e} relative")
    check(failures, len(card) == len(cpu) == c["steps"]
          and bool(np.all(np.isfinite(card))) and worst <= CARD_CPU_TOL,
          f"train: the {c['arch']} CLI's card losses {card} against the "
          f"CPU's {cpu}")


def train_phase(torch, cfg, failures):
    """Training on the card, then the trained model compressed and served.

    (a) opus-mt full() (remat "full") from init_params(seed 0) on the
    LatentMarkovTask(32000, seed 0, branching 4, classes 16), batch 8 x
    seq 128, AdamW lr 1e-3, 10% warmup, cosine over TRAIN["steps"], through
    launch/train.py's step in a ResilientLoop (checkpoints every
    TRAIN["ckpt_every"] steps, a failure injected at TRAIN["fail_at"],
    between the first two): every loss finite, the last 10
    below the first 10, the replayed steps within TRAIN_TOL of the first
    pass; step ms, tokens/s, peak bytes beside the FLOP bound; then
    REMAT_STEPS steps with remat full, dots and off and with the 8-bit
    AdamW state, and TRAIN_BIG's steps at a training-size batch with
    remat full, dots and off (ms, peak bytes), four of them profiled.
    (a') the train CLI on the card (`train_cli_check`).
    (b) 3 steps from the same weights and batches on the card and on the
    CPU: loss and grad norm within CARD_CPU_TOL. (c) the trained state
    through ckpt.save, ckpt.restore and bridge.load_checkpoint: equal.
    (d) the trained weights compressed under the mixed and the quant-only
    plan, serving 16 task prompts captured (a first serve captures the
    step graphs; the second's launches by kernel and shape checked) and 4
    short ones card == CPU. (e) held-out greedy accuracy
    (benchmarks/common.py's token_accuracy: 6 batches of 8 x 64 at step
    10,000) of the dense and both compressed models, and the accept rate
    of SPEC's draft on the trained mixed plan (its tokens the plain
    serve's). Returns the launches of (d) and (e)."""
    import shutil

    import numpy as np

    from repro_torch import bridge
    from repro_torch.api.engine import (InferenceEngine, SamplingParams,
                                        _full_fp32, params_to)
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import LatentMarkovTask
    from repro_torch.hw.h100_model import PEAK_FLOPS_FP32
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_accum_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime.speculation import DraftSpec

    _full_fp32()
    out_dir = ROOT / "build" / "train"
    shutil.rmtree(out_dir, ignore_errors=True)
    task = LatentMarkovTask(cfg.vocab_size, seed=0, branching=4, classes=16)
    steps = TRAIN["steps"]
    opt_cfg = adamw.AdamWConfig(lr=TRAIN["lr"], warmup_steps=steps // 10,
                                total_steps=steps)
    tokens = TRAIN["batch"] * TRAIN["seq"]

    # (a) the resilient run ------------------------------------------------
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, log, report = run_train(
        torch, cfg, opt_cfg, task, steps, ckpt_dir=str(out_dir / "ckpt"),
        loop_kw=dict(ckpt_every=TRAIN["ckpt_every"],
                     inject_failure_at=TRAIN["fail_at"]))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    losses = report.losses
    first, replay = {}, {}
    for s, loss, _ in log:
        (replay if s in first else first)[s] = loss
    ms = [t for s, _, t in log[5:]]
    ms_p50 = float(np.median(ms))
    floor = task.entropy_floor()
    print(f"[train] {report.steps_run} steps in {wall:.1f} s: failures "
          f"{report.failures}, restores {report.restores}, stragglers "
          f"{report.straggler_events}; replayed steps {min(replay)}-"
          f"{max(replay)}")
    flops = train_flops(cfg, tokens, cfg.remat, TRAIN["seq"])
    bound_ms = flops / PEAK_FLOPS_FP32 * 1e3
    print(f"[train] step ms p50 {ms_p50:.2f} (min {min(ms):.2f}, max "
          f"{max(ms):.2f}) after 5 warm-up steps; "
          f"{tokens / ms_p50 * 1e3:.0f} tokens/s; bound {bound_ms:.2f} ms "
          f"({flops / 1e12:.3f} TFLOP at the "
          f"fp32 peak, TF32 off) = {bound_ms / ms_p50:.3f} of the step; "
          f"peak {peak} bytes above the {base} already allocated")
    first10, last10 = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"[train] loss first10 {first10:.4f} last10 {last10:.4f}; "
          f"entropy floor {floor:.4f}; uniform {np.log(cfg.vocab_size):.4f}")
    check(failures, bool(np.all(np.isfinite(losses))), "train: a loss is "
          "not finite")
    check(failures, last10 < first10, "train: the loss did not decrease")
    check(failures, report.failures == 1 and report.restores == 1
          and len(replay) == TRAIN["fail_at"] - TRAIN["ckpt_every"],
          f"train: {report.failures} failures, {report.restores} restores, "
          f"{len(replay)} steps replayed")
    worst = max(abs(replay[s] - first[s]) / abs(first[s]) for s in replay)
    same = all(replay[s] == first[s] for s in replay)
    print(f"[train] replayed losses: largest relative difference "
          f"{worst:.3e}, bit-equal: {same}")
    check(failures, worst <= TRAIN_TOL, f"train: a replayed loss differs "
          f"by {worst:.3e} relative")

    # remat full / dots / off, and the 8-bit AdamW state, at the phase's
    # batch and at a training-size one ---------------------------------------
    opt8 = dataclasses.replace(opt_cfg, state_bits=8)
    small = (TRAIN["batch"], TRAIN["seq"], REMAT_STEPS, 3)
    big = (TRAIN_BIG["batch"], TRAIN_BIG["seq"], TRAIN_BIG["steps"], 2)
    for name, remat, policy, ocfg, size, profiled in (
            ("remat full", True, "full", opt_cfg, small, True),
            ("remat dots", True, "dots", opt_cfg, small, False),
            ("remat off", False, "full", opt_cfg, small, True),
            ("remat full, 8-bit AdamW state", True, "full", opt8, small,
             False),
            ("remat full", True, "full", opt_cfg, big, True),
            ("remat dots", True, "dots", opt_cfg, big, False),
            ("remat off", False, "full", opt_cfg, big, True)):
        bsz, seq, nsteps, warm = size
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        b0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rstate, rlog, _ = run_train(torch, c, ocfg, task, nsteps, batch=bsz,
                                    seq=seq)
        rms = float(np.median([t for _, _, t in rlog[warm:]]))
        rb = train_flops(c, bsz * seq, remat and policy == "full", seq) \
            / PEAK_FLOPS_FP32 * 1e3
        print(f"[train] {bsz} x {seq} {name}: {rms:.2f} ms a step (bound "
              f"{rb:.2f} = {rb / rms:.3f} of it), "
              f"{bsz * seq / rms * 1e3:.0f} tokens/s, peak "
              f"{torch.cuda.max_memory_allocated() - b0} bytes above {b0}; "
              f"losses {rlog[0][1]:.4f} .. {rlog[-1][1]:.4f}")
        if profiled:
            profile_steps(torch, c, ocfg, task, rstate,
                          f"train {bsz} x {seq}, {name}", batch=bsz, seq=seq)
        del rstate
    torch.cuda.empty_cache()

    # (a') the train CLI on the card ----------------------------------------
    train_cli_check(torch, cfg, out_dir, failures)
    frontend_cli_check(torch, out_dir, failures)

    # (b) card against the CPU ----------------------------------------------
    step = make_accum_train_step(cfg, opt_cfg, 1)
    sides = {}
    for dev in ("cuda", "cpu"):
        p = params_to(tfm.init_params(cfg, seed=0, device="cuda"), dev)
        sides[dev] = [p, adamw.init(p, opt_cfg)]
    worst = 0.0
    for s in range(3):
        batch = task.batch(s, TRAIN["batch"], TRAIN["seq"])
        m = {}
        for dev, st in sides.items():
            st[0], st[1], m[dev] = step(st[0], st[1], {
                k: v.to(dev) for k, v in batch.items()})
        g = [float(m["cuda"][k]) for k in ("loss", "grad_norm")]
        c = [float(m["cpu"][k]) for k in ("loss", "grad_norm")]
        rel = [abs(a - b) / abs(b) for a, b in zip(g, c)]
        worst = max(worst, *rel)
        print(f"[train] card vs CPU step {s}: loss {g[0]:.7f} / {c[0]:.7f}, "
              f"grad norm {g[1]:.6f} / {c[1]:.6f}, relative "
              f"{rel[0]:.3e} / {rel[1]:.3e}")
    check(failures, worst <= CARD_CPU_TOL, f"train: card and CPU differ by "
          f"{worst:.3e} relative")
    del sides

    # (c) checkpoint round trip ---------------------------------------------
    path = str(out_dir / "trained")
    ckpt.save(path, steps, state)
    back, _ = ckpt.restore(path, state)
    host = ckpt.flatten(bridge.load_checkpoint(path))
    want = ckpt.flatten(state)
    got = ckpt.flatten(back)
    equal = (sorted(want) == sorted(got) == sorted(host)
             and all(torch.equal(want[k], got[k])
                     and torch.equal(want[k].cpu(), host[k]) for k in want))
    print(f"[train] checkpoint of {len(want)} tensors: restore and bridge "
          f"equal: {equal}")
    check(failures, equal, "train: the checkpoint round trip differs")
    trained = state["params"]
    del state, back, host, got, want

    # (d) serve the trained weights -----------------------------------------
    rng = np.random.default_rng(5)
    reqs = [task.batch(30_000 + i, 1, int(n))["tokens"][0].numpy()
            for i, n in enumerate(rng.integers(32, 257, 16))]
    short = [task.batch(40_000 + i, 1, n)["tokens"][0].numpy()
             for i, n in enumerate((16, 29, 47, 64))]
    sp = SamplingParams(max_tokens=32)
    engines = {}
    served = {}
    build.reset_launches()                     # (d)'s and (e)'s runs start
    for name, make_plan in (("mixed", mixed_plan), ("quant-only", quant_plan)):
        eng = InferenceEngine.build(cfg, make_plan(trained), params=trained,
                                    device="cuda", max_batch=8, block_size=16)
        eng.serve(reqs, sp)         # captures every step shape it takes
        torch.cuda.synchronize()
        before = dict(build.LAUNCHES)
        shapes0 = dict(build.LAUNCH_SHAPES)
        res = serve_checked(torch, eng, "trained kv16", reqs, sp, before,
                            failures)
        counts = {k: build.LAUNCHES[k] - before.get(k, 0)
                  for k in build.SOURCES}
        shapes = {key[1:]: c - shapes0.get(key, 0)
                  for key, c in build.LAUNCH_SHAPES.items()
                  if key[0] == "quant_matmul"}
        out = np.stack(res.outputs)
        prev = np.concatenate([np.array([r[-1] for r in reqs])[:, None],
                               out[:, :-1]], axis=1)
        valid = np.mean([[o in task.succ[p] for p, o in zip(pr, ou)]
                         for pr, ou in zip(prev, out)])
        print(f"[train] {name} plan on the trained weights: launches "
              f"{counts}; quant_matmul by (K, N) {shapes}; "
              f"{valid:.4f} of emitted tokens are successors the task "
              f"allows")
        check_compared(failures, f"trained {name}")
        per = (quant_launch_shapes(cfg) if name == "quant-only"
               else {(cfg.d_model, cfg.vocab_size): 1})
        for (k, n), c in per.items():
            check(failures, shapes.get((k, n), 0) == c * res.steps,
                  f"trained {name}: quant_matmul K{k}->N{n} "
                  f"{shapes.get((k, n), 0)} launches, expected {c} a step "
                  f"x {res.steps}")
        lr_per = sum(lowrank_launch_shapes(cfg).values()) \
            if name == "mixed" else 0
        check(failures, counts["lowrank_qmm"] == lr_per * res.steps,
              f"trained {name}: {counts['lowrank_qmm']} lowrank_qmm "
              f"launches, expected {lr_per} a step x {res.steps}")
        check(failures, counts["paged_attention"] == cfg.num_layers
              * res.steps, f"trained {name}: {counts['paged_attention']} "
              f"paged_attention launches")
        cpu = InferenceEngine(cfg, cpu_copy(eng.params),
                              device=torch.device("cpu"), plan=eng.plan)
        parity(torch, f"trained {eng.plan.label} kv16", eng, cpu, short,
               SamplingParams(max_tokens=8), failures)
        engines[name], served[name] = eng, res

    # (e) what trained weights answer ---------------------------------------
    acc = {name: heldout_accuracy(torch, cfg, params, task, (6, 8, 64))
           for name, params in (("dense", trained),
                                ("quant-only W4", engines["quant-only"].params),
                                ("ITERA W4 r0.5", engines["mixed"].params))}
    check_compared(failures, "trained accuracy")
    print("[train] held-out greedy next-token accuracy (6 x 8 x 64 at step "
          "10,000; the lm head W8A8 in both compressed plans): "
          + ", ".join(f"{k} {v:.4f}" for k, v in acc.items()))
    mixed = engines["mixed"]
    seng = InferenceEngine(cfg, mixed.params, device=mixed.device,
                           plan=mixed.plan, max_batch=8, block_size=16,
                           speculate=DraftSpec(**SPEC))
    seng.serve(reqs, sp)            # captures every step shape it takes
    res = seng.serve(reqs, sp)
    torch.cuda.synchronize()
    check_compared(failures, "trained speculation")
    print(f"[train] SPEC draft (k {SPEC['k']}, rank fraction "
          f"{SPEC['rank_fraction']}) on the trained mixed plan: drafted "
          f"{res.drafted}, accepted {res.accepted}, accept rate "
          f"{res.accept_rate:.4f} (random weights: 0.033); {res.steps} steps "
          f"against {served['mixed'].steps} plain; TPOT p50 "
          f"{res.tpot_p50 * 1e3:.2f} ms against "
          f"{served['mixed'].tpot_p50 * 1e3:.2f}, "
          f"{res.tokens_per_second:.1f} tok/s against "
          f"{served['mixed'].tokens_per_second:.1f}")
    check(failures, all(np.array_equal(a, b) for a, b in
                        zip(res.outputs, served["mixed"].outputs)),
          "train: the speculative tokens differ from the plain serve's")
    return dict(build.LAUNCHES)                # ... and end here


# ------------------------------------------------------------ moe phase --
MOE_DEPTH = 1            # of deepseek-moe-16b's 28 layers
# ITERA's power iterations a rank-1 step in the moe phase (the plans'
# default is 24), for the phase's time: it compresses 4 x 3 stacks of 64
# experts at R 704 on the card. The phase prints one stack's error at
# both counts.
MOE_POWER_ITERS = 4


def moe_launches(cfg, plan: str) -> dict:
    """Kernel launches of one serve step (or one generate pass, less
    attention) of the moe model: each layer's 4 attention linears, its 3
    expert projections (one launch for all experts each) and its 3 shared
    ones, and the lm head."""
    n = cfg.num_layers * (4 + 3 + 3)
    if plan == "mixed":
        return {"lowrank_qmm": n, "quant_matmul": 1,
                "paged_attention": cfg.num_layers}
    return {"quant_matmul": n + 1, "paged_attention": cfg.num_layers}


def expert_bytes(params) -> int:
    """Device bytes of every layer's routed-expert stacks (codes and
    scales): what a decode step's expert launches must stream."""
    from repro_torch.core.compress import flatten

    total = 0
    for path, leaf in flatten(params).items():
        if "/experts/" not in path:
            continue
        for q in ([leaf.w1, leaf.w2] if hasattr(leaf, "w1") else [leaf]):
            total += (q.values.numel() * q.values.element_size()
                      + q.scale.numel() * 4)
    return total


@contextlib.contextmanager
def routed_copies(moe):
    """Every `moe.route` call's (tokens, capacity, target rows) inside the
    block, by wrapping the function `moe_apply` calls: an eager run calls
    it in every step, a captured step only at its capture."""
    records, real = [], moe.route

    def route(params, xt, cfg, capacity):
        out = real(params, xt, cfg, capacity)
        records.append((xt.shape[0], capacity, out[4]))
        return out

    moe.route = route
    try:
        yield records
    finally:
        moe.route = real


def routing_stats(records, num_experts: int) -> dict:
    """{tokens of a call: [calls, copies routed, copies dropped]} over
    `routed_copies`' records (a decode step's calls have max_batch
    tokens, a prefill chunk's more); a dropped copy's target is the dump
    row E * C."""
    out: dict = {}
    for t, cap, tgt in records:
        row = out.setdefault(t, [0, 0, 0])
        row[0] += 1
        row[1] += tgt.numel()
        row[2] += int((tgt == num_experts * cap).sum())
    return out


def moe_phase(torch, failures):
    """deepseek-moe-16b at its published widths, 1 of its 28 layers, fp32,
    seed-0 random weights, compressed on the card under the mixed and the
    quant-only plan; served captured (greedy fp32 and int8 KV, sampled)
    and eagerly, with every step's launches checked exactly; routing
    statistics by step kind; generate timed and held to the CPU's; card ==
    CPU serves of 4 short requests. Returns the phase's launches."""
    import numpy as np

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.configs import get_config
    from repro_torch.core.itera import itera_decompose, reconstruction_error
    from repro_torch.hw.h100_model import HBM_BW
    from repro_torch.kernels import build
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_params

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              num_layers=MOE_DEPTH, dtype="float32")
    m = cfg.moe
    print(f"[moe] {cfg.name}: d_model {cfg.d_model}, {cfg.num_heads} heads "
          f"of {cfg.head_dim}, {m.num_experts} experts of d_ff {cfg.d_ff} "
          f"top-{m.top_k} + {m.num_shared} shared, capacity factor "
          f"{m.capacity_factor}, vocab {cfg.vocab_size}; depth "
          f"{cfg.num_layers} of 28, {cfg.dtype}: "
          f"{cfg.param_count() / 1e9:.3f} B parameters, "
          f"{cfg.active_param_count() / 1e9:.3f} B active a token")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[moe] dense fp32 weights made on the card in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # one stack of routed experts (layer 0's up projection, r0.5) under
    # ITERA W4 at the phase's power iterations and at the default
    w = params["layers"]["moe"]["experts"]["up"][0]
    for iters in (MOE_POWER_ITERS, 24):
        t0 = time.perf_counter()
        lr = itera_decompose(w, min(w.shape[-2:]) // 2, 4,
                             power_iters=iters)
        err = float(reconstruction_error(w, lr))
        print(f"[moe] layer 0 experts/up {tuple(w.shape)}, ITERA W4 R "
              f"{lr.rank}, {iters} power iterations: relative error "
              f"{err:.6f}, {time.perf_counter() - t0:.1f} s")
    del w, lr
    engines = {}
    for name, plan in (
            ("mixed", mixed_plan(params, MOE_EXCLUDE,
                                 power_iters=MOE_POWER_ITERS)),
            ("quant-only", quant_plan(params, MOE_EXCLUDE))):
        t0 = time.perf_counter()
        eng = InferenceEngine.build(cfg, plan, params=params, device="cuda",
                                    max_batch=8, block_size=16)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(failures, not any("router" in lp.path for lp in eng.plan.layers),
              f"moe {name}: the router was compressed")
        print(f"[moe] {name} ({eng.plan.label}): compressed on the card in "
              f"{secs:.1f} s; weights {eng.weight_hbm_bytes() / 2**20:.1f} "
              f"MiB, routed experts {expert_bytes(eng.params) / 2**20:.1f} "
              f"MiB; {eng.report.summary()}")
        engines[name] = eng
    del params, eng
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
            for n in rng.integers(32, 257, 8)]
    sp = SamplingParams(max_tokens=16)
    sampled = SamplingParams(max_tokens=16, temperature=0.8, top_k=50,
                             top_p=0.9, seed=7)
    launches: collections.Counter = collections.Counter()
    prompts = rng.integers(1, cfg.vocab_size, (8, 128)).astype(np.int32)
    for name, eng in engines.items():
        plan = "mixed" if name == "mixed" else "quant"
        per_step = moe_launches(cfg, plan)
        c8 = dataclasses.replace(cfg, kv_cache_bits=8)
        eng8 = InferenceEngine(c8, eng.params, device=eng.device,
                               plan=eng.plan, max_batch=8, block_size=16)
        eager = InferenceEngine(cfg, eng.params, device=eng.device,
                                plan=eng.plan, max_batch=8, block_size=16,
                                cuda_graphs=False)
        # warm-up: every step shape of the timed serves captured first
        for e, s in ((eng, sp), (eng8, sp), (eng, sampled)):
            e.serve(reqs, s)
        torch.cuda.synchronize()
        runs = {}
        for label, e, s in (("greedy kv16", eng, sp),
                            ("greedy int8 KV", eng8, sp),
                            ("sampled kv16", eng, sampled),
                            ("greedy kv16 eager", eager, sp)):
            build.reset_launches()
            # the routing of every step, from the eager run (a captured
            # step records only at its capture)
            with (routed_copies(moe) if e is eager
                  else contextlib.nullcontext([])) as rec:
                res = e.serve(reqs, s)
                torch.cuda.synchronize()
            counts, shapes = dict(build.LAUNCHES), dict(build.LAUNCH_SHAPES)
            launches.update(counts)
            runs[label] = (res, counts, shapes, rec)
            check_compared(failures, f"moe {name} {label}")
            want = {k: v * res.steps for k, v in per_step.items()}
            check(failures, counts == want,
                  f"moe {name} {label}: launches {counts} over {res.steps} "
                  f"steps, expected {per_step} a step")
            out = np.stack(res.outputs)
            check(failures, out.shape == (len(reqs), s.max_tokens) and bool(
                ((out >= 0) & (out < cfg.vocab_size)).all()),
                f"moe {name} {label}: outputs {out.shape} out of range")
            print(f"[moe] {name} {label}: {res.total_tokens} tokens, prompts "
                  f"{min(res.prompt_lens)}-{max(res.prompt_lens)}, "
                  f"{res.steps} steps; TPOT p50 {res.tpot_p50 * 1e3:.2f} ms, "
                  f"TTFT p50 {res.ttft_p50 * 1e3:.1f} ms, "
                  f"{res.tokens_per_second:.1f} tok/s; launches {counts} "
                  f"({', '.join(f'{k} {v}' for k, v in per_step.items())} "
                  "a step)")
        (cap, ccounts, cshapes, _) = runs["greedy kv16"]
        (eag, ecounts, eshapes, rec) = runs["greedy kv16 eager"]
        check(failures, all(np.array_equal(a, b) for a, b in
                            zip(cap.outputs, eag.outputs)),
              f"moe {name}: eager and captured serve tokens differ")
        check(failures, (ecounts, eshapes) == (ccounts, cshapes),
              f"moe {name}: eager and captured launch counters differ")
        for t, (calls, routed, dropped) in sorted(
                routing_stats(rec, m.num_experts).items()):
            kind = ("decode" if t == eng.max_batch
                    else f"prefill W {t // eng.max_batch}")
            print(f"[moe] {name} routing, {kind} steps ({t} positions, "
                  f"capacity {moe.capacity_for(t, cfg)}): {calls // MOE_DEPTH}"
                  f" steps, {routed} copies routed, {dropped} dropped "
                  f"({100 * dropped / max(routed, 1):.1f}%)")
        nbytes = expert_bytes(eng.params)
        print(f"[moe] {name}: a decode step's expert launches stream "
              f"{nbytes / 1e9:.4f} GB ({nbytes / MOE_DEPTH / 1e6:.1f} MB a "
              f"layer): at least {nbytes / HBM_BW * 1e3:.4f} ms at "
              f"{HBM_BW / 1e12:.2f} TB/s; TPOT p50 "
              f"{cap.tpot_p50 * 1e3:.2f} ms")
        profile_run(torch, lambda: eng.serve(reqs, sp).steps,
                    f"moe {name} serve")
        # generate: 8 prompts of 128 tokens, 16 new (one prefill, 15
        # decode passes); launches exact, no paged attention
        eng.generate(prompts, SamplingParams(max_tokens=2))    # warm-up
        torch.cuda.synchronize()
        build.reset_launches()
        res = eng.generate(prompts, sp)
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        launches.update(counts)
        check_compared(failures, f"moe {name} generate")
        want = {k: v * sp.max_tokens for k, v in per_step.items()
                if k != "paged_attention"}
        check(failures, counts == want,
              f"moe {name} generate: launches {counts}, expected {want}")
        print(f"[moe] {name} generate 8 x 128, 16 new: {res.seconds * 1e3:.1f}"
              f" ms, {res.tokens_per_second:.1f} tok/s; launches {counts}")
        del eng8, eager

    # card == CPU: the same compressed tensors on the CPU (plain versions)
    short = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
             for n in (16, 27, 38, 48)]
    rect = rng.integers(1, cfg.vocab_size, (4, 29)).astype(np.int32)
    sp8 = SamplingParams(max_tokens=8)
    sampled8 = SamplingParams(max_tokens=8, temperature=0.8, top_k=50,
                              top_p=0.9, seed=7)
    for name, eng in engines.items():
        t0 = time.perf_counter()
        cpu = InferenceEngine(cfg, cpu_copy(eng.params),
                              device=torch.device("cpu"), plan=eng.plan,
                              max_batch=8, block_size=16)
        parity(torch, f"moe {name} kv16", eng, cpu, short, sp8, failures)
        parity(torch, f"moe {name} kv16 sampled", eng, cpu, short, sampled8,
               failures)
        generate_parity(torch, f"moe {name}", eng, cpu, rect, sp8, failures)
        print(f"[moe] {name}: CPU parity in {time.perf_counter() - t0:.1f} s")
        del cpu
    print(f"[moe] phase took {time.perf_counter() - t_phase:.1f} s")
    engines.clear()
    torch.cuda.empty_cache()
    return dict(launches)


# ----------------------------------------------------------- bf16 phase --
# of phi3-medium-14b's and stablelm-12b's 40 layers
BF16_DEPTH = 1
BF16_STABLELM_DEPTH = 1
# ITERA's power iterations a rank-1 step in the bf16 phase (the plans'
# default is 24), for the phase's time, as the moe phase's
BF16_POWER_ITERS = 4


def bf16_mixed_plan(params, rank_fraction=BF16_RANK_FRACTION):
    """The bf16 and nemotron phases' mixed plan: ITERA W4A8 for every
    attention and MLP linear, at the reference's default rank fraction 0.5
    in the bf16 phase (R 2560 at phi3's 5120-wide factors, wide rank
    slices with T on chip), and the W8A8 lm head."""
    from repro_torch.api.plan import CompressionPlan, LayerPlan

    base = CompressionPlan.uniform(params, method="itera", weight_wl=4,
                                   rank_fraction=rank_fraction,
                                   exclude=EXCLUDE,
                                   power_iters=BF16_POWER_ITERS)
    return base.replace(layers=base.layers + (LayerPlan("lm_head", "quant",
                                                        8),),
                        label=f"itera_W4A8_r{rank_fraction}+lm_head_W8A8")


def dense_launches(cfg, plan: str) -> dict:
    """Kernel launches of one serve step of a dense model: each layer's
    linears (wq, wk, wv, wo, up, down, and gate where the MLP is gated:
    SwiGLU, GeGLU) and its attention, and the lm head."""
    n = (6 + (cfg.mlp_act in ("swiglu", "geglu"))) * cfg.num_layers
    if plan == "mixed":
        return {"lowrank_qmm": n, "quant_matmul": 1,
                "paged_attention": cfg.num_layers}
    return {"quant_matmul": n + 1, "paged_attention": cfg.num_layers}


def bf16_serves(torch, name, per_step, reqs, runs, failures, launches,
                tag="bf16"):
    """Serve `reqs` for each (label, engine, sampling) of `runs`, each
    with the launch counters zeroed just before: launches exact a step,
    every lowrank_qmm launch on a compared code path and every
    quant_matmul launch at a compared (K, N), outputs in range. Returns
    {label: ServeResult}."""
    import numpy as np

    from repro_torch.kernels import build

    out = {}
    for label, e, sp in runs:
        build.reset_launches()
        res = e.serve(reqs, sp)
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        launches.update(counts)
        check_compared(failures, f"{tag} {name} {label}")
        qmm = {key[1:] for key in build.LAUNCH_SHAPES
               if key[0] == "quant_matmul"}
        check(failures, qmm <= COMPARED_QMM,
              f"{tag} {name} {label}: quant_matmul launched at (K, N) "
              f"{sorted(qmm - COMPARED_QMM)}, which phase 2 did not compare")
        want = {k: v * res.steps for k, v in per_step.items()}
        check(failures, counts == want,
              f"{tag} {name} {label}: launches {counts} over {res.steps} "
              f"steps, expected {per_step} a step")
        toks = np.stack(res.outputs)
        check(failures, toks.shape == (len(reqs), sp.max_tokens) and bool(
            ((toks >= 0) & (toks < e.cfg.vocab_size)).all()),
            f"{tag} {name} {label}: outputs {toks.shape} out of range")
        print(f"[{tag}] {name} {label}: {res.total_tokens} tokens, prompts "
              f"{min(res.prompt_lens)}-{max(res.prompt_lens)}, {res.steps} "
              f"steps; TPOT p50 {res.tpot_p50 * 1e3:.2f} ms, TTFT p50 "
              f"{res.ttft_p50 * 1e3:.1f} ms, {res.tokens_per_second:.1f} "
              f"tok/s; launches {counts}")
        out[label] = res
    return out


def bf16_phase(torch, failures):
    """phi3-medium-14b at its published widths in bfloat16, 1 of its 40
    layers, seed-0 random weights, compressed on the card under the mixed
    plan (ITERA W4A8 r0.5, W8A8 lm head) and quant-only W4A8; served
    captured (greedy with a bf16 and an int8 pool, seeded sampled) and
    eagerly, launches exact a step; stablelm-12b (Dh 160, LayerNorm,
    partial rotary), 1 of 40 layers, quant-only, greedy at both pools;
    card == CPU for 4 short requests on every one of those paths.
    Returns the phase's launches."""
    import numpy as np

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    t_phase = time.perf_counter()
    rng = np.random.default_rng(21)
    launches: collections.Counter = collections.Counter()
    sp = SamplingParams(max_tokens=16)
    sampled = SamplingParams(max_tokens=16, temperature=0.8, top_k=50,
                             top_p=0.9, seed=7)
    sp8 = SamplingParams(max_tokens=8)
    sampled8 = SamplingParams(max_tokens=8, temperature=0.8, top_k=50,
                              top_p=0.9, seed=7)
    models = (("phi3-medium-14b", BF16_DEPTH,
               (("mixed", bf16_mixed_plan), ("quant-only", quant_plan))),
              ("stablelm-12b", BF16_STABLELM_DEPTH,
               (("quant-only", quant_plan),)))
    for arch, depth, plans in models:
        cfg = dataclasses.replace(get_config(arch), num_layers=depth)
        print(f"[bf16] {cfg.name}: d_model {cfg.d_model}, {cfg.num_heads} "
              f"heads of {cfg.head_dim} over {cfg.num_kv_heads} KV heads, "
              f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.norm}, "
              f"rotary {cfg.rotary_pct}; depth {depth} of 40, {cfg.dtype}: "
              f"{cfg.param_count() / 1e9:.3f} B parameters")
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        print(f"[bf16] dense {cfg.dtype} weights made on the card in "
              f"{time.perf_counter() - t0:.1f} s: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        engines = {}
        for name, make in plans:
            t0 = time.perf_counter()
            eng = InferenceEngine.build(cfg, make(params), params=params,
                                        device="cuda", max_batch=8,
                                        block_size=16)
            torch.cuda.synchronize()
            print(f"[bf16] {arch} {name} ({eng.plan.label}): compressed on "
                  f"the card in {time.perf_counter() - t0:.1f} s; weights "
                  f"{eng.weight_hbm_bytes() / 2**20:.1f} MiB; "
                  f"{eng.report.summary()}")
            engines[name] = eng
        del params
        torch.cuda.empty_cache()
        reqs = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
                for n in rng.integers(32, 257, 8)]
        short = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
                 for n in (16, 27, 38, 48)]
        for name, eng in engines.items():
            per_step = dense_launches(
                cfg, "mixed" if name == "mixed" else "quant")
            eng8 = InferenceEngine(dataclasses.replace(cfg, kv_cache_bits=8),
                                   eng.params, device=eng.device,
                                   plan=eng.plan, max_batch=8, block_size=16)
            runs = [("greedy bf16 KV", eng, sp), ("greedy int8 KV", eng8, sp)]
            if arch == "phi3-medium-14b":
                eager = InferenceEngine(cfg, eng.params, device=eng.device,
                                        plan=eng.plan, max_batch=8,
                                        block_size=16, cuda_graphs=False)
                runs.append(("greedy bf16 KV eager", eager, sp))
                if name == "mixed":
                    runs.append(("sampled bf16 KV", eng, sampled))
            for _, e, s in runs:            # warm-up: capture every shape
                e.serve(reqs, s)
            torch.cuda.synchronize()
            res = bf16_serves(torch, f"{arch} {name}", per_step, reqs, runs,
                              failures, launches)
            if "greedy bf16 KV eager" in res:
                cap, eag = res["greedy bf16 KV"], res["greedy bf16 KV eager"]
                check(failures, all(np.array_equal(a, b) for a, b in
                                    zip(cap.outputs, eag.outputs)),
                      f"bf16 {arch} {name}: eager and captured serve tokens "
                      f"differ")
                profile_run(torch, lambda: eng.serve(reqs, sp).steps,
                            f"bf16 {arch} {name} serve")
            # card == CPU: the same compressed tensors on the CPU
            t0 = time.perf_counter()
            cpu_params = cpu_copy(eng.params)
            for kv, e in ((16, eng), (8, eng8)):
                c = dataclasses.replace(cfg, kv_cache_bits=kv)
                cpu = InferenceEngine(c, cpu_params,
                                      device=torch.device("cpu"),
                                      plan=eng.plan, max_batch=8,
                                      block_size=16)
                label = f"bf16 {arch} {name} kv{kv}"
                parity(torch, label, e, cpu, short, sp8, failures)
                if kv == 16 and name == "mixed":
                    parity(torch, f"{label} sampled", e, cpu, short,
                           sampled8, failures)
                del cpu
            print(f"[bf16] {arch} {name}: CPU parity in "
                  f"{time.perf_counter() - t0:.1f} s")
            del cpu_params, eng8, runs
        engines.clear()
        torch.cuda.empty_cache()
    print(f"[bf16] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches)


# --------------------------------------------------------- gemma2 phase --
GEMMA2_DEPTH = 2         # of gemma2-9b's 42 layers: one local/global pair
GEMMA2_RANK_FRACTION = 0.5
GEMMA2_TIMED = (8, 128, 16)      # prompts x tokens, new tokens
GEMMA2_SHORT = (4, 32, 8)        # the card == CPU generate
# one prompt past the local window (4096) and the tokens generated after
# it: the prefill's window mask and the rolling local cache's wrap at
# published widths
GEMMA2_LONG = (4100, 24)
GEMMA2_MARGIN = 0.1      # top-two logits this close may flip (C2's rule)


def gemma2_plans(params):
    """gemma2's two plans: ITERA W4A8 at rank fraction 0.5 (R 1792 and,
    for wk and wv, 1024) and quant-only W4A8, every attention and MLP
    linear; the tied head stays the dense bf16 product."""
    from repro_torch.api.plan import CompressionPlan

    itera = CompressionPlan.uniform(params, method="itera", weight_wl=4,
                                    rank_fraction=GEMMA2_RANK_FRACTION,
                                    exclude=EXCLUDE,
                                    power_iters=BF16_POWER_ITERS)
    quant = CompressionPlan.uniform(params, method="quant", weight_wl=4,
                                    exclude=EXCLUDE)
    return {"mixed": itera.replace(label="itera_W4A8_r0.5"),
            "quant-only": quant.replace(label="quant_W4A8")}


def gemma2_window_check(torch, eng, failures) -> None:
    """One prompt of GEMMA2_LONG[0] tokens (past the 4096-token local
    window) generated GEMMA2_LONG[1] tokens on the card, checked against
    the card's own `forward` over prompt + generated tokens, teacher
    forced: each token is that forward's argmax at its position, except
    where forward's top two logits lie within GEMMA2_MARGIN (at most
    one such position)."""
    import numpy as np

    from repro_torch.api.engine import SamplingParams
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tfm

    s, n = GEMMA2_LONG
    cfg = eng.cfg
    prompt = np.random.default_rng(41).integers(1, cfg.vocab_size, (1, s))
    prompt = prompt.astype(np.int32)
    build.reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompt, SamplingParams(max_tokens=n)).tokens[0]
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check_compared(failures, "gemma2 window-crossing generate")
    seq = np.concatenate([prompt[0], out[:-1]])
    with torch.inference_mode():
        h, _ = tfm.forward(eng._step_params,
                           torch.from_numpy(seq[None]).cuda(), cfg)
        logits = tfm.logits_for(eng._step_params, h[:, s - 1:], cfg)[0]
    torch.cuda.synchronize()
    check_compared(failures, "gemma2 window-crossing forward")
    top = torch.topk(logits.float(), 2, dim=-1)
    want = top.indices[:, 0].cpu().numpy()
    margin = (top.values[:, 0] - top.values[:, 1]).cpu().numpy()
    differ = np.flatnonzero(want != out)
    close = bool((margin[differ] < GEMMA2_MARGIN).all())
    print(f"[gemma2] window-crossing: {s}-token prompt (local window "
          f"{cfg.local_window}), {n} new tokens in {gen_s:.2f} s; "
          f"teacher-forced forward over {s + n - 1} tokens: {len(differ)} "
          f"of {n} positions differ (at margins "
          f"{[round(float(x), 4) for x in margin[differ]]}); smallest "
          f"margin {float(margin.min()):.4f}")
    check(failures, len(differ) <= 1 and close,
          f"gemma2 window-crossing: {len(differ)} generated tokens differ "
          f"from the teacher-forced forward's argmax (margins "
          f"{margin[differ].tolist()})")


def gemma2_phase(torch, failures):
    """gemma2-9b at its published widths (d_model 3584, 16 heads of 256
    over 8 KV heads, GeGLU d_ff 14336, vocab 256,000, tied embeddings,
    soft caps 50 and 30), bfloat16, 2 of its 42 layers (one local/global
    pair, local window 4096), seed-0 random weights, compressed on the
    card under ITERA W4A8 r0.5 (R 1792 / 1024) and quant-only W4A8; each
    plan's `generate` of 8 x 128 prompts, 16 new tokens, greedy captured
    and eager (the mixed plan also sampled): launches exactly 14 of the
    plan's kernel a pass, captured == eager tokens; prefill ms, decode ms
    a step and tok/s; card == CPU on 4 x 32 prompts, 8 new, under both
    plans; the mixed plan's window-crossing run. Returns the phase's
    launches."""
    import numpy as np

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LatentMarkovTask
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_params

    t_phase = time.perf_counter()
    launches: collections.Counter = collections.Counter()
    cfg = dataclasses.replace(get_config("gemma2-9b"),
                              num_layers=GEMMA2_DEPTH)
    print(f"[gemma2] {cfg.name}: d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads of {cfg.head_dim} over {cfg.num_kv_heads} KV heads, d_ff "
          f"{cfg.d_ff} {cfg.mlp_act}, vocab {cfg.vocab_size} tied, local "
          f"window {cfg.local_window} on even layers, soft caps "
          f"{cfg.logit_softcap} / {cfg.final_softcap}; depth {GEMMA2_DEPTH} "
          f"of 42, {cfg.dtype}: {cfg.param_count() / 1e9:.3f} B parameters; "
          f"{card_line()}")
    params = init_params(cfg, seed=0, device="cuda")
    engines = {}
    for name, plan in gemma2_plans(params).items():
        t0 = time.perf_counter()
        eng = InferenceEngine.build(cfg, plan, params=params, device="cuda")
        torch.cuda.synchronize()
        print(f"[gemma2] {name} ({eng.plan.label}): compressed on the card "
              f"in {time.perf_counter() - t0:.1f} s; weights "
              f"{eng.weight_hbm_bytes() / 2**20:.1f} MiB; "
              f"{eng.report.summary()}")
        engines[name] = eng
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(43)
    b, s, n = GEMMA2_TIMED
    prompts = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    sb, ss, sn = GEMMA2_SHORT
    short = rng.integers(1, cfg.vocab_size, (sb, ss)).astype(np.int32)
    sp = SamplingParams(max_tokens=n)
    one = SamplingParams(max_tokens=1)
    sampled = SamplingParams(max_tokens=n, temperature=0.8, top_k=50,
                             top_p=0.9, seed=7)
    for name, eng in engines.items():
        kernel = "lowrank_qmm" if name == "mixed" else "quant_matmul"
        per_pass = {kernel: 7 * cfg.num_layers}
        eager = InferenceEngine(cfg, eng.params, device=eng.device,
                                plan=eng.plan, cuda_graphs=False)
        runs = [("greedy captured", eng, sp), ("greedy eager", eager, sp)]
        if name == "mixed":
            runs.append(("sampled captured", eng, sampled))
        for _, e, p in runs:                # warm-up: capture every shape
            e.generate(prompts, p)
            e.generate(prompts, one)
        torch.cuda.synchronize()
        toks = {}
        for label, e, p in runs:
            pre = e.generate(prompts, one)
            build.reset_launches()
            res = e.generate(prompts, p)
            torch.cuda.synchronize()
            counts = dict(build.LAUNCHES)
            launches.update(counts)
            check_compared(failures, f"gemma2 {name} {label}")
            want = {k: v * n for k, v in per_pass.items()}
            check(failures, counts == want,
                  f"gemma2 {name} {label}: launches {counts}, expected "
                  f"{per_pass} a pass x {n}")
            out = np.asarray(res.tokens)
            check(failures, out.shape == (b, n) and bool(
                ((out >= 0) & (out < cfg.vocab_size)).all()),
                f"gemma2 {name} {label}: tokens {out.shape} out of range")
            toks[label] = out
            print(f"[gemma2] {name} {label}: generate {b} x {s} prompts, "
                  f"{n} tokens: {res.seconds * 1e3:.1f} ms, prefill "
                  f"{pre.seconds * 1e3:.1f} ms, decode "
                  f"{(res.seconds - pre.seconds) * 1e3 / (n - 1):.2f} ms a "
                  f"step, {res.tokens_per_second:.1f} tok/s; launches "
                  f"{counts}")
        check(failures, np.array_equal(toks["greedy captured"],
                                       toks["greedy eager"]),
              f"gemma2 {name}: captured and eager generate tokens differ")
        profile_run(torch, lambda: (eng.generate(prompts, sp), n)[1],
                    f"gemma2 {name} generate")
        if name == "mixed":
            gemma2_window_check(torch, eng, failures)
        t0 = time.perf_counter()
        cpu = InferenceEngine(cfg, cpu_copy(eng.params),
                              device=torch.device("cpu"), plan=eng.plan)
        generate_parity(torch, f"gemma2 {name}", eng, cpu, short,
                        SamplingParams(max_tokens=sn), failures)
        print(f"[gemma2] {name}: CPU parity in {time.perf_counter() - t0:.1f}"
              f" s")
        del cpu, eager, runs
    engines.clear()
    torch.cuda.empty_cache()
    print(f"[gemma2] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches)


# ---------------------------------------------------- mamba-train phase --
# falcon-mamba-7b and zamba2-2.7b trained at their published widths and
# MAMBA_DEPTHS in bf16 through the chunked engine on `batch` x seq tokens
# a step, AdamW with 8-bit state (a 32-bit state's checkpoints, 10 bytes a
# parameter, cost more than its steps: PERF.md section 4) and a warmup of
# `warmup` steps; a checkpoint every ckpt_every steps (and at step 0) and
# a failure injected at fail_at, after the first one
MAMBA_TRAIN = {"falcon-mamba-7b": dict(batch=8, seq=128),
               # its step time at 8 x 128: PERF.md section 6
               "zamba2-2.7b": dict(batch=4, seq=128)}
MAMBA_STEPS = dict(steps=20, lr=3e-4, warmup=5, state_bits=8, ckpt_every=11,
                   fail_at=13)
MAMBA_ENGINE_STEPS = 2   # steps each engine takes from the same state
MAMBA_CPU = (1, 32)      # batch x seq of the card == CPU steps
# loss and grad norm of one bf16 step from the same state and batch on two
# devices or through two engines, relative: their float32 sums (a bf16
# matmul's, the scan's) run in other orders, and a last-bit difference
# flips a bf16 rounding now and then. On the CPU the port's bf16 losses
# lie 2e-4-3e-4 from the reference's and its gradients as far from the
# reference's as the reference's from its own fp32 gradient
# (tests/test_torch_mamba_train.py, ROADMAP C8).
MAMBA_BF16_TOL = {"loss": 2e-3, "grad_norm": 2e-2}
# the falcon-mamba-7b train CLI (its smoke config: a full-width step runs
# the sequential engine over 64 layers)
MAMBA_CLI = dict(steps=6, batch=4, seq=32, microbatches=2, ckpt_every=3,
                 fail_at=4)
MAMBA_EVAL = (3, 8, 128)  # held-out batches x rows x tokens (M 1024)


def mamba_train_flops(cfg, tokens: int, seq: int) -> float:
    """Least FLOPs of a Mamba train step: 2 a linear parameter and token
    (every block's projections, the hybrid's shared block at each
    invocation, the lm head) plus the shared attention's QK^T and PV over
    the causal half (2 seq d_model a token and invocation), three times
    that with the backward pass, four under remat "full". The scan's
    elementwise work (Di x d_state a token and layer, under 0.5% of
    these) is left out."""
    d, c = cfg.d_model, cfg.ssm
    di = d * c.expand
    if c.version == 1:
        dtr = c.dt_rank or d // 16
        layer = d * 2 * di + di * dtr + di * 2 * c.d_state + dtr * di \
            + di * d
    else:
        layer = d * 2 * di + d * 2 * c.d_state + d * (di // c.head_dim) \
            + di * d
    uses = cfg.num_layers // cfg.hybrid_period \
        if cfg.layout == "hybrid" else 0
    shared = 4 * d * d + 2 * d * cfg.d_ff
    forward = 2 * (cfg.num_layers * layer + uses * shared
                   + d * cfg.vocab_size) + uses * 2 * seq * d
    return (4 if cfg.remat and cfg.remat_policy == "full" else 3) \
        * forward * tokens


def state_32bit(state):
    """A train state with 8-bit AdamW moments as one with 32-bit moments:
    each dequantized, the parameters and the count shared."""
    from repro_torch.optim import adamw

    leaves = adamw.leaf_paths(state["params"])
    opt = state["opt"]
    return {"params": state["params"], "opt": {
        "m": adamw.unflatten((p, adamw._dq8(adamw._at(opt["m"], p), x.shape))
                             for p, x in leaves),
        "v": adamw.unflatten((p, adamw._dq8log(adamw._at(opt["v"], p),
                                               x.shape))
                             for p, x in leaves),
        "count": opt["count"]}}


def heldout_accuracy(torch, cfg, params, task, shape=MAMBA_EVAL,
                     ssm_engine="chunked"):
    """Greedy next-token accuracy of `params` on held-out LatentMarkovTask
    batches (`shape`: batches x rows x tokens, from step 10,000),
    `forward` without gradients (the Mamba blocks through `ssm_engine`)."""
    import numpy as np

    from repro_torch.models import transformer as tfm

    n, rows, seq = shape
    hits = []
    with torch.inference_mode():
        for i in range(n):
            b = task.batch(10_000 + i, rows, seq, device="cuda")
            h, _ = tfm.forward(params, b["tokens"], cfg,
                               ssm_engine=ssm_engine)
            pred = torch.argmax(tfm.logits_for(params, h, cfg), dim=-1)
            hits.append(float((pred == b["labels"]).float().mean()))
    return float(np.mean(hits))


def mamba_cpu_steps(arch, step, host, batches, on_card, sec):
    """The CPU's half of the mamba-train phase's check (c): `step` from
    the `host` state on each of `batches`, each step's loss and grad norm
    held to the card's (`on_card`) within MAMBA_BF16_TOL. Returns the
    lines to print and the failed checks."""
    import torch

    lines, failures = [], []
    t0 = time.perf_counter()
    for i, (b, mg) in enumerate(zip(batches, on_card)):
        host["params"], host["opt"], m = step(host["params"], host["opt"], b)
        mc = {k: float(m[k]) for k in MAMBA_BF16_TOL}
        rel = {k: abs(mg[k] - mc[k]) / abs(mc[k]) for k in MAMBA_BF16_TOL}
        lines.append(
            f"[mamba-train] {arch}: card vs CPU step {i} "
            f"({len(b['tokens'])} x {b['tokens'].shape[1]}, sequential): loss "
            f"{mg['loss']:.7f} / {mc['loss']:.7f}, grad norm "
            f"{mg['grad_norm']:.6f} / {mc['grad_norm']:.6f}, relative "
            f"{rel['loss']:.3e} / {rel['grad_norm']:.3e}")
        check(failures, all(rel[k] <= t for k, t in MAMBA_BF16_TOL.items()),
              f"mamba-train {arch}: card and CPU differ at step {i}: {rel}")
    lines.append(
        f"[mamba-train] {arch}: card vs CPU: the state to the CPU "
        f"{sec['copy']:.1f} s, steps on the card {sec['cuda']:.1f} s, on the "
        f"CPU ({torch.get_num_threads()} threads, on a thread of the phase) "
        f"{time.perf_counter() - t0:.1f} s")
    return lines, failures


def join_cpu_steps(pending, failures) -> None:
    """Wait for `mamba_cpu_steps` futures; print their lines and add their
    failed checks to `failures`."""
    for done in pending:
        lines, failed = done.result()
        print("\n".join(lines))
        failures.extend(failed)


def mamba_train_phase(torch, failures, defer=None):
    """Training of the Mamba layouts on the card: falcon-mamba-7b and
    zamba2-2.7b at their published widths, MAMBA_DEPTHS of their layers
    (zamba2's shared block runs twice), bf16, remat "full" (the full
    configs'), seed-0 random weights, on LatentMarkovTask(vocab, seed 0,
    branching 4, classes 16).
    (a) MAMBA_STEPS' steps of MAMBA_TRAIN's batch through
    `make_train_step(..., ssm_engine="chunked")` in a ResilientLoop with a
    checkpoint and an injected failure: every loss finite, the last 10
    below the first 10, the replayed steps within TRAIN_TOL of the first
    pass; step ms, tokens/s and peak bytes beside the FLOP bound at the
    bf16 peak; a profile of one step.
    (b) MAMBA_ENGINE_STEPS steps from the trained state, each taken from
    the same state and batch by the chunked and the sequential engine:
    loss and grad norm within MAMBA_BF16_TOL (the reference's equivalence
    of its engines); the first one's gradients taken twice, the leaves
    that differ in any bit printed.
    (c) the same number of steps on MAMBA_CPU's batch through the
    sequential engine on the card and on the CPU from one copy of that
    state (its moments dequantized to 32 bits): within MAMBA_BF16_TOL;
    the CPU's steps (`mamba_cpu_steps`) run on a thread while the phase
    goes on (falcon-mamba-7b's while zamba2-2.7b trains); with a `defer`
    list, those still running when the phase ends are appended to it for
    the caller to join (`join_cpu_steps`), else the phase waits for them.
    (d) falcon-mamba-7b's train CLI on the card (`train_cli_check`, its
    smoke config, MAMBA_CLI).
    (e) the trained model's held-out greedy accuracy (`heldout_accuracy`).
    Returns {arch: (config, trained parameters on the card, accuracy)} for
    the mamba phase to compress and generate from."""
    import shutil

    import numpy as np

    from repro_torch.api.engine import _full_fp32, params_to
    from repro_torch.configs import get_config
    from repro_torch.core.compress import map_with_path
    from repro_torch.data.pipeline import LatentMarkovTask
    from repro_torch.hw.h100_model import PEAK_FLOPS_BF16
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.optim import adamw

    _full_fp32()
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "mamba_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    c = MAMBA_STEPS
    trained = {}
    cpu_pool = concurrent.futures.ThreadPoolExecutor(1)
    cpu_steps = []          # each arch's card == CPU steps (c), on the pool
    for arch, depth in MAMBA_DEPTHS.items():
        t_arch = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=depth)
        bsz, seq = MAMBA_TRAIN[arch]["batch"], MAMBA_TRAIN[arch]["seq"]
        tokens = bsz * seq
        task = LatentMarkovTask(cfg.vocab_size, seed=0, branching=4,
                                classes=16)
        opt_cfg = adamw.AdamWConfig(lr=c["lr"], warmup_steps=c["warmup"],
                                    total_steps=c["steps"],
                                    state_bits=c["state_bits"])
        print(f"[mamba-train] {arch}: depth {depth} of {full.num_layers}, "
              f"{cfg.dtype}, remat {cfg.remat_policy if cfg.remat else 'off'}"
              f", chunk {cfg.ssm.chunk}; {cfg.param_count() / 1e9:.3f} B "
              f"parameters; {bsz} x {seq} tokens a step; AdamW "
              f"{c['state_bits']}-bit state; {card_line()}")

        # (a) the resilient run through the chunked engine ----------------
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, log, report = run_train(
            torch, cfg, opt_cfg, task, c["steps"], batch=bsz, seq=seq,
            ssm_engine="chunked", ckpt_dir=str(out_dir / arch),
            loop_kw=dict(ckpt_every=c["ckpt_every"],
                         inject_failure_at=c["fail_at"]))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        losses = report.losses
        first, replay = {}, {}
        for s, loss, _ in log:
            (replay if s in first else first)[s] = loss
        ms = [t for _, _, t in log[2:]]
        ms_p50 = float(np.median(ms))
        ckpt_s = wall - sum(t for _, _, t in log) / 1e3
        flops = mamba_train_flops(cfg, tokens, seq)
        bound_ms = flops / PEAK_FLOPS_BF16 * 1e3
        print(f"[mamba-train] {arch}: {report.steps_run} steps in {wall:.1f}"
              f" s, {ckpt_s:.1f} s of it outside the steps (checkpoints, "
              f"restore, batches): failures {report.failures}, restores "
              f"{report.restores}; replayed steps {min(replay)}-"
              f"{max(replay)}")
        print(f"[mamba-train] {arch}: step ms p50 {ms_p50:.2f} (min "
              f"{min(ms):.2f}, max {max(ms):.2f}) after 2 warm-up steps "
              f"({log[0][2]:.1f}, {log[1][2]:.1f}); "
              f"{tokens / ms_p50 * 1e3:.0f} tokens/s; bound {bound_ms:.3f} "
              f"ms ({flops / 1e12:.3f} TFLOP at the bf16 peak) = "
              f"{bound_ms / ms_p50:.4f} of the step; peak {peak} bytes "
              f"({peak / 2**30:.2f} GiB) above the {base} already allocated")
        first10, last10 = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"[mamba-train] {arch}: losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + f"; first10 {first10:.4f} last10 {last10:.4f}; entropy "
              f"floor {task.entropy_floor():.4f}; uniform "
              f"{np.log(cfg.vocab_size):.4f}")
        check(failures, bool(np.all(np.isfinite(losses))),
              f"mamba-train {arch}: a loss is not finite")
        check(failures, last10 < first10,
              f"mamba-train {arch}: the loss did not decrease")
        check(failures, report.failures == 1 and report.restores == 1
              and len(replay) == c["fail_at"] - c["ckpt_every"],
              f"mamba-train {arch}: {report.failures} failures, "
              f"{report.restores} restores, {len(replay)} steps replayed")
        worst = max(abs(replay[s] - first[s]) / abs(first[s])
                    for s in replay)
        same = all(replay[s] == first[s] for s in replay)
        print(f"[mamba-train] {arch}: replayed losses: largest relative "
              f"difference {worst:.3e}, bit-equal: {same}")
        check(failures, worst <= TRAIN_TOL, f"mamba-train {arch}: a "
              f"replayed loss differs by {worst:.3e} relative")
        shutil.rmtree(out_dir / arch)

        # (b) the two engines from the same state ---------------------------
        engines = {e: make_train_step(cfg, opt_cfg, ssm_engine=e)
                   for e in ("chunked", "sequential")}
        def clone(tree):
            return map_with_path(lambda _, t: t.clone(), tree)

        cur = clone(state)
        for i in range(MAMBA_ENGINE_STEPS):
            b = task.batch(20_000 + i, bsz, seq, device="cuda")
            if i == 0:
                # the gradients' bits, taken twice: the embedding's
                # backward scatters with atomics
                g = [adamw.leaf_paths(loss_and_grads(
                    cur["params"], b, cfg, ssm_engine="chunked")[1])
                    for _ in range(2)]
                moved = [p for (p, x), (_, y) in zip(*g)
                         if not torch.equal(x, y)]
                print(f"[mamba-train] {arch}: gradients taken twice on the "
                      f"same state and batch: {len(g[0]) - len(moved)} of "
                      f"{len(g[0])} leaves bit-equal; differing: "
                      f"{moved or 'none'}")
                del g
            m, sec = {}, {}
            for e in ("sequential", "chunked"):
                st = clone(cur) if e == "sequential" else cur
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st["params"], st["opt"], m[e] = engines[e](
                    st["params"], st["opt"], b)
                torch.cuda.synchronize()
                sec[e] = time.perf_counter() - t0
                del st
            rel = {k: abs(float(m["sequential"][k]) - float(m["chunked"][k]))
                   / abs(float(m["chunked"][k])) for k in MAMBA_BF16_TOL}
            print(f"[mamba-train] {arch}: engines from the same state, step "
                  f"{i}: loss {float(m['sequential']['loss']):.6f} "
                  f"(sequential, {sec['sequential'] * 1e3:.0f} ms) / "
                  f"{float(m['chunked']['loss']):.6f} (chunked, "
                  f"{sec['chunked'] * 1e3:.0f} ms), grad norm "
                  f"{float(m['sequential']['grad_norm']):.6f} / "
                  f"{float(m['chunked']['grad_norm']):.6f}; relative "
                  f"{rel['loss']:.3e} / {rel['grad_norm']:.3e}")
            check(failures, all(rel[k] <= t for k, t
                                in MAMBA_BF16_TOL.items()),
                  f"mamba-train {arch}: the sequential engine differs from "
                  f"the chunked one at step {i}: {rel}")
        profile_run(torch, lambda: (engines["chunked"](
            cur["params"], cur["opt"],
            task.batch(20_100, bsz, seq, device="cuda")), 1)[1],
            f"mamba-train {arch} chunked step {bsz} x {seq}")

        # (c) the card against the CPU from the same state -------------------
        # Trained moments: no first step's sign-like update to amplify a
        # difference. Dequantized to 32 bits, and through the sequential
        # engine (held to the chunked one in (b)): on the CPU the 8-bit
        # update and the chunked engine's float64 scan cost most of the
        # phase at these widths (PERF.md section 4). The card's steps run
        # here; the CPU's on a thread while the phase goes on, joined and
        # checked before it ends.
        cb, cs = MAMBA_CPU
        t0 = time.perf_counter()
        cur = state_32bit(cur)
        host = params_to(cur, "cpu")
        step32 = make_train_step(cfg, dataclasses.replace(
            opt_cfg, state_bits=32), ssm_engine="sequential")
        sec = {"copy": time.perf_counter() - t0}
        batches = [task.batch(30_000 + i, cb, cs)
                   for i in range(MAMBA_ENGINE_STEPS)]
        t0 = time.perf_counter()
        on_card = []
        for b in batches:
            cur["params"], cur["opt"], m = step32(
                cur["params"], cur["opt"],
                {k: v.to("cuda") for k, v in b.items()})
            on_card.append({k: float(m[k]) for k in MAMBA_BF16_TOL})
        sec["cuda"] = time.perf_counter() - t0
        cpu_steps.append(cpu_pool.submit(mamba_cpu_steps, arch, step32,
                                         host, batches, on_card, sec))
        del cur, host, engines
        torch.cuda.empty_cache()

        # (d) the train CLI ---------------------------------------------------
        if arch == "falcon-mamba-7b":
            train_cli_check(torch, get_config(arch, smoke=True), out_dir,
                            failures, arch=arch, smoke=True, c=MAMBA_CLI,
                            tag="mamba-train")

        # (e) what the trained weights answer --------------------------------
        acc = heldout_accuracy(torch, cfg, state["params"], task)
        print(f"[mamba-train] {arch}: held-out greedy next-token accuracy "
              f"of the trained dense model ({MAMBA_EVAL[0]} x "
              f"{MAMBA_EVAL[1]} x {MAMBA_EVAL[2]} at step 10,000, chunked "
              f"engine): {acc:.4f}; {time.perf_counter() - t_arch:.1f} s")
        trained[arch] = (cfg, state["params"], acc)
        del state
        torch.cuda.empty_cache()
    if defer is None:
        join_cpu_steps(cpu_steps, failures)
    else:
        join_cpu_steps([f for f in cpu_steps if f.done()], failures)
        defer.extend(f for f in cpu_steps if not f.done())
    cpu_pool.shutdown(wait=False)
    print(f"[mamba-train] phase took {time.perf_counter() - t_phase:.1f} s"
          + (f"; {len(defer)} arch's card == CPU steps still run on the "
             f"CPU" if defer else ""))
    return trained


# ---------------------------------------------------------- mamba phase --
def mamba_launches(cfg, plan: str) -> dict:
    """Kernel launches of one pass of a Mamba model (`prefill` or one
    `decode_step`): each block's projections (Mamba1: in_proj, dt_in,
    bc_proj, dt_proj, out_proj; Mamba2: zx_proj, bc_in, dt_lin, out_proj),
    the hybrid's shared block's six linears at each invocation, and the
    W8 lm head; no attention kernel (`generate` attends over the
    contiguous cache in plain PyTorch)."""
    n = (5 if cfg.ssm.version == 1 else 4) * cfg.num_layers
    if cfg.layout == "hybrid":
        n += 6 * (cfg.num_layers // cfg.hybrid_period)
    if plan == "mixed":
        return {"lowrank_qmm": n, "quant_matmul": 1}
    return {"quant_matmul": n + 1}


def mamba_phase(torch, failures, trained=None):
    """falcon-mamba-7b (Mamba1, attention-free: d_model 4096, Di 8192,
    d_state 16, dt_rank 256, vocab 65,024) and zamba2-2.7b (Mamba2 blocks,
    80 heads of 64, d_state 64, and a shared attention + GELU block of 32
    heads of 80 after every 6: d_model 2560, vocab 32,000) at their
    published widths in bfloat16, MAMBA_DEPTHS of their layers, the
    mamba-train phase's trained weights (`trained`, as it returns them;
    seed-0 random weights without it), compressed on the card under the
    mixed plan (ITERA W4A8 r0.5, W8A8 lm head) and quant-only W4A8 (same
    head), and, trained, each compressed model's held-out greedy accuracy
    beside the dense one's (`heldout_accuracy`); each plan's
    `generate` of 8 x 128 prompts, 16 new tokens, greedy (and, mixed,
    sampled), captured: launches exactly `mamba_launches` a pass, every
    lowrank_qmm launch on a compared code path and every quant_matmul
    (K, N) compared in phase 2, none of paged_attention; prefill ms,
    decode ms a step and tok/s; a profile of each plan's decode steps;
    card
    == CPU on 4 x 32 prompts, 8 new, greedy, and sampled under the mixed
    plan. A decode step's time is the held step graph's replays between
    CUDA events, and a profile of those replays gives the card's busy
    share of captured decode. Returns the phase's launches."""
    import numpy as np

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LatentMarkovTask
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_params

    t_phase = time.perf_counter()
    launches: collections.Counter = collections.Counter()
    b, s, n = MAMBA_TIMED
    sb, ss, sn = MAMBA_SHORT
    sp, one = SamplingParams(max_tokens=n), SamplingParams(max_tokens=1)
    sampled = SamplingParams(max_tokens=n, temperature=0.8, top_k=50,
                             top_p=0.9, seed=7)
    for arch, depth in MAMBA_DEPTHS.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=depth)
        c = cfg.ssm
        print(f"[mamba] {cfg.name} ({cfg.layout}, Mamba{c.version}): d_model "
              f"{cfg.d_model}, Di {cfg.d_model * c.expand}, d_state "
              f"{c.d_state}, d_conv {c.d_conv}"
              + (f", dt_rank {c.dt_rank}" if c.version == 1 else
                 f", {cfg.d_model * c.expand // c.head_dim} heads of "
                 f"{c.head_dim}; shared block: {cfg.num_heads} heads of "
                 f"{cfg.head_dim}, {cfg.mlp_act} d_ff {cfg.d_ff}, every "
                 f"{cfg.hybrid_period} layers")
              + f", vocab {cfg.vocab_size}; depth {depth} of "
              f"{full.num_layers}, {cfg.dtype}: "
              f"{cfg.param_count() / 1e9:.3f} B parameters; {card_line()}")
        dense_acc = None
        if trained:
            _, params, dense_acc = trained.pop(arch)
        else:
            params = init_params(cfg, seed=0, device="cuda")
        engines = {}
        mixed = functools.partial(bf16_mixed_plan,
                                  rank_fraction=MAMBA_RANK_FRACTION)
        for name, make in (("mixed", mixed), ("quant-only", quant_plan)):
            t0 = time.perf_counter()
            eng = InferenceEngine.build(cfg, make(params), params=params,
                                        device="cuda")
            torch.cuda.synchronize()
            print(f"[mamba] {arch} {name} ({eng.plan.label}): compressed on "
                  f"the card in {time.perf_counter() - t0:.1f} s; weights "
                  f"{eng.weight_hbm_bytes() / 2**20:.1f} MiB; "
                  f"{eng.report.summary()}")
            engines[name] = eng
        del params
        torch.cuda.empty_cache()
        if dense_acc is not None:
            task = LatentMarkovTask(cfg.vocab_size, seed=0, branching=4,
                                    classes=16)
            acc = {name: heldout_accuracy(torch, cfg, eng.params, task)
                   for name, eng in engines.items()}
            check_compared(failures, f"mamba {arch} trained accuracy")
            print(f"[mamba] {arch} trained: held-out greedy next-token "
                  f"accuracy ({MAMBA_EVAL[0]} x {MAMBA_EVAL[1]} x "
                  f"{MAMBA_EVAL[2]} at step 10,000, chunked engine; the lm "
                  f"head W8A8 in both plans): dense {dense_acc:.4f}, "
                  + ", ".join(f"{k} {v:.4f}" for k, v in acc.items()))
        rng = np.random.default_rng(26)
        prompts = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
        short = rng.integers(1, cfg.vocab_size, (sb, ss)).astype(np.int32)
        for name, eng in engines.items():
            per_pass = mamba_launches(cfg, "mixed" if name == "mixed"
                                      else "quant")
            runs = [("greedy captured", sp)]
            if name == "mixed":
                runs.append(("sampled captured", sampled))
            for label, p in runs:
                eng.generate(prompts, p)        # warm-up: capture the step
                pre = eng.generate(prompts, one)
                build.reset_launches()
                res = eng.generate(prompts, p)
                torch.cuda.synchronize()
                counts = dict(build.LAUNCHES)
                launches.update(counts)
                check_compared(failures, f"mamba {arch} {name} {label}")
                qmm = {key[1:] for key in build.LAUNCH_SHAPES
                       if key[0] == "quant_matmul"}
                check(failures, qmm <= COMPARED_QMM,
                      f"mamba {arch} {name} {label}: quant_matmul launched "
                      f"at (K, N) {sorted(qmm - COMPARED_QMM)}, which phase "
                      f"2 did not compare")
                want = {k: v * n for k, v in per_pass.items()}
                check(failures, counts == want,
                      f"mamba {arch} {name} {label}: launches {counts}, "
                      f"expected {per_pass} a pass x {n}")
                out = np.asarray(res.tokens)
                check(failures, out.shape == (b, n) and bool(
                    ((out >= 0) & (out < cfg.vocab_size)).all()),
                    f"mamba {arch} {name} {label}: tokens {out.shape} out "
                    f"of range")
                # the eager prefill's time varies more than a whole decode
                # takes, so a decode step is timed on its own: the held
                # step graph replayed n - 1 times between CUDA events
                step = eng._decoder(b, s + n, p.temperature > 0)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n - 1):
                    step()
                end.record()
                torch.cuda.synchronize()
                print(f"[mamba] {arch} {name} {label}: generate {b} x {s} "
                      f"prompts, {n} tokens: {res.seconds * 1e3:.1f} ms, "
                      f"{res.tokens_per_second:.1f} tok/s; prefill "
                      f"{pre.seconds * 1e3:.1f} ms; decode "
                      f"{start.elapsed_time(end) / (n - 1):.3f} ms a step "
                      f"(replays, CUDA events); launches {counts}")
            step = eng._decoder(b, s + n, False)
            profile_run(torch, lambda: ([step() for _ in range(n - 1)],
                                        n - 1)[1],
                        f"mamba {arch} {name} decode replays")
            t0 = time.perf_counter()
            cpu = InferenceEngine(cfg, cpu_copy(eng.params),
                                  device=torch.device("cpu"), plan=eng.plan)
            short_sp = SamplingParams(max_tokens=sn)
            generate_parity(torch, f"mamba {arch} {name}", eng, cpu, short,
                            short_sp, failures)
            if name == "mixed":
                generate_parity(torch, f"mamba {arch} {name} sampled", eng,
                                cpu, short, dataclasses.replace(
                                    sampled, max_tokens=sn), failures)
            print(f"[mamba] {arch} {name}: CPU parity in "
                  f"{time.perf_counter() - t0:.1f} s")
            del cpu
        engines.clear()
        torch.cuda.empty_cache()
    print(f"[mamba] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches)


# ------------------------------------------------------- nemotron phase --
NEMOTRON_DEPTH = 1       # of nemotron-4-340b's 96 layers
# ITERA's rank fraction in the nemotron phase: R 1152 at the 18432-wide
# factors, 64 at wk and wv (rank_multiple 64). At the reference's default
# 0.5 (R 9216) Alg. 1 takes about ten minutes a layer on the card: each of
# its rank-1 steps reads the float32 residual of `up` (5.4 GB) about nine
# times at 4 power iterations (PERF.md section 4)
NEMOTRON_RANK_FRACTION = 0.0625
NEMOTRON_SHORT = (16, 27, 38, 48)   # prompt tokens of the card == CPU serves


def nemotron_phase(torch, failures):
    """nemotron-4-340b at its published widths in bfloat16 (d_model 18432,
    96 heads of 192 over 8 KV heads, squared-ReLU d_ff 73728, LayerNorm,
    half the head dims rotary, vocab 256,000), NEMOTRON_DEPTH of its 96
    layers, seed-0 random weights, compressed on the card under the mixed
    plan (ITERA W4A8 r0.0625: R 1152 and 64, W8A8 lm head) and quant-only
    W4A8; 8 requests of 32-256 prompt tokens, 16 new, served captured,
    greedy with a bf16 and an int8 pool: launches exactly 6 lowrank_qmm +
    1 quant_matmul + 1 paged_attention (mixed) or 7 quant_matmul + 1
    paged_attention (quant-only) a step, every launch at a shape phase 2
    compared; a profile of each plan's serve; card == CPU for 4 short
    requests, 8 new, on every one of those paths. Returns the phase's
    launches."""
    import numpy as np

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.configs import get_config
    from repro_torch.hw.h100_model import NUM_SMS
    from repro_torch.kernels import lowrank_qmm as lr
    from repro_torch.models.transformer import init_params

    t_phase = time.perf_counter()
    launches: collections.Counter = collections.Counter()
    cfg = dataclasses.replace(get_config("nemotron-4-340b"),
                              num_layers=NEMOTRON_DEPTH)
    print(f"[nemotron] {cfg.name}: d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads of {cfg.head_dim} over {cfg.num_kv_heads} KV heads, d_ff "
          f"{cfg.d_ff} {cfg.mlp_act}, {cfg.norm}, rotary {cfg.rotary_pct}, "
          f"vocab {cfg.vocab_size}; depth {NEMOTRON_DEPTH} of 96, "
          f"{cfg.dtype}: {cfg.param_count() / 1e9:.3f} B parameters; "
          f"{card_line()}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[nemotron] dense {cfg.dtype} weights made on the card in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    engines = {}
    mixed = functools.partial(bf16_mixed_plan,
                              rank_fraction=NEMOTRON_RANK_FRACTION)
    for name, make in (("mixed", mixed), ("quant-only", quant_plan)):
        t0 = time.perf_counter()
        eng = InferenceEngine.build(cfg, make(params), params=params,
                                    device="cuda", max_batch=8,
                                    block_size=16)
        torch.cuda.synchronize()
        print(f"[nemotron] {name} ({eng.plan.label}): compressed on the "
              f"card in {time.perf_counter() - t0:.1f} s; weights "
              f"{eng.weight_hbm_bytes() / 2**30:.2f} GiB; "
              f"{eng.report.summary()}")
        engines[name] = eng
    del params
    torch.cuda.empty_cache()
    _, served = bf16_geometry()
    d = cfg.d_model
    for k, r, n in served:
        if d not in (k, n):
            continue
        for m in (8, 2048):
            t = lr.choose_tiles(m, r, n, NUM_SMS, lr.smem_bytes)
            print(f"[nemotron] lowrank_qmm M {m} K {k} R {r} N {n}: "
                  f"{t.path} path, rank slices of {t.rs} columns, bm "
                  f"{t.bm}, cluster {t.cluster}")
    rng = np.random.default_rng(25)
    reqs = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
            for n in rng.integers(32, 257, 8)]
    short = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
             for n in NEMOTRON_SHORT]
    sp, sp8 = SamplingParams(max_tokens=16), SamplingParams(max_tokens=8)
    for name, eng in engines.items():
        per_step = dense_launches(cfg, "mixed" if name == "mixed"
                                  else "quant")
        eng8 = InferenceEngine(dataclasses.replace(cfg, kv_cache_bits=8),
                               eng.params, device=eng.device, plan=eng.plan,
                               max_batch=8, block_size=16)
        runs = [("greedy bf16 KV", eng, sp), ("greedy int8 KV", eng8, sp)]
        for _, e, p in runs:                # warm-up: capture every shape
            e.serve(reqs, p)
        torch.cuda.synchronize()
        bf16_serves(torch, name, per_step, reqs, runs, failures, launches,
                    tag="nemotron")
        profile_run(torch, lambda: eng.serve(reqs, sp).steps,
                    f"nemotron {name} serve")
        t0 = time.perf_counter()
        cpu_params = cpu_copy(eng.params)
        for kv, e in ((16, eng), (8, eng8)):
            cpu = InferenceEngine(dataclasses.replace(cfg, kv_cache_bits=kv),
                                  cpu_params, device=torch.device("cpu"),
                                  plan=eng.plan, max_batch=8, block_size=16)
            parity(torch, f"nemotron {name} kv{kv}", e, cpu, short, sp8,
                   failures)
            del cpu
        print(f"[nemotron] {name}: CPU parity in "
              f"{time.perf_counter() - t0:.1f} s")
        del cpu_params, eng8, runs
    engines.clear()
    torch.cuda.empty_cache()
    print(f"[nemotron] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches)


def cpu_copy(params):
    """`params` on the CPU for a card == CPU engine, every packed W4 node
    in its int8-carrier layout: the same codes, so the plain versions
    give the same bits, without unpacking the nibbles at every call (which
    took most of nemotron's CPU parity: 1.36 G codes a matrix)."""
    from repro_torch.core.compress import map_with_path
    from repro_torch.core.itera import LowRankQ
    from repro_torch.core.quant import QuantizedTensor, unpack_weights

    def one(_, leaf):
        leaf = leaf.to("cpu")
        if isinstance(leaf, LowRankQ):
            return LowRankQ(unpack_weights(leaf.w1), unpack_weights(leaf.w2))
        if isinstance(leaf, QuantizedTensor):
            return unpack_weights(leaf)
        return leaf

    return map_with_path(one, params)


def generate_parity(torch, label, gpu, cpu, prompts, sp, failures) -> None:
    """`prompts` (equal lengths) generated on the card and on the CPU: the
    tokens must be identical; every card lowrank_qmm launch on a code path
    phase 2 compared."""
    import numpy as np

    from repro_torch.kernels import build

    build.reset_launches()
    rg = gpu.generate(prompts, sp).tokens
    torch.cuda.synchronize()
    check_compared(failures, f"{label} generate")
    rc = cpu.generate(prompts, sp).tokens
    diff = first_difference(torch, cpu, prompts, rc, rg)
    if diff is not None:
        i, p, margin = diff
        print(f"  {label} generate row {i} differs at position {p}: card "
              f"{rg[i, p]} cpu {rc[i, p]}; CPU top-2 margin {margin:.3e}")
    check(failures, diff is None, f"{label}: card and CPU generate differ")
    print(f"[parity] {label} generate: {prompts.shape[0]} x "
          f"{prompts.shape[1]} prompts x {sp.max_tokens} tokens, card == "
          f"CPU: {diff is None}")


def parity(torch, label, gpu, cpu, short, sp, failures) -> None:
    """`short` served by the card's and the CPU's engine: the tokens must
    be identical; at a difference, the logit margin is printed."""
    import numpy as np

    rg, rc = gpu.serve(short, sp), cpu.serve(short, sp)
    same = True
    for i, (a, b) in enumerate(zip(rg.outputs, rc.outputs)):
        if np.array_equal(a, b):
            continue
        same = False
        s = int(np.argmax(a != b))
        seq = np.concatenate([short[i], a[:s]])
        lg = last_logits(torch, gpu, seq)
        lc = last_logits(torch, cpu, seq)
        top = torch.topk(lc, 2)
        print(f"  {label} request {i} differs at step {s}: card {a[s]} "
              f"cpu {b[s]}; CPU top-2 {top.indices.tolist()} margin "
              f"{float(top.values[0] - top.values[1]):.3e}; card logit gap "
              f"{float(lg[a[s]] - lg[b[s]]):.3e}")
        check(failures, False, f"{label} request {i}: card and CPU tokens "
              f"differ")
    print(f"[parity] {label}: {len(short)} requests x {sp.max_tokens} "
          f"tokens, card == CPU: {same}")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}; run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.api.engine import InferenceEngine, SamplingParams
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.runtime.speculation import DraftSpec

    print(f"device: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build (and 2. kernels vs their plain versions) -------------
    # each library builds on its own thread; phase 2 checks the integer
    # kernels while paged_attention, the longest build, still compiles
    builds = Builds(build)
    failures: list = []
    timer = Timer(torch)
    build.reset_launches()
    builds.wait("quant_matmul")
    kern = {"quant_matmul": check_quant_matmul(torch, timer, failures)}
    builds.wait("lowrank_qmm")
    kern["lowrank_qmm"] = check_lowrank_qmm(torch, timer, failures)
    worst = check_expert_stacks(torch, failures)
    for name in ("quant_matmul", "lowrank_qmm"):
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], worst)
    kern["lowrank_qmm"]["max_abs_err"] = max(
        kern["lowrank_qmm"]["max_abs_err"],
        check_large_ranks(torch, failures))
    for name, err in check_mamba_kernels(torch, timer, failures).items():
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], err)
    builds.wait("paged_attention")
    print(builds.report())
    print_ptxas(failures)
    kern["paged_attention"] = check_paged_attention(torch, timer, failures)
    for name, err in check_bf16_kernels(torch, failures).items():
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], err)
    for name, err in check_tp_kernels(torch, failures).items():
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], err)
    note_compared()
    print(f"[kernels] {timer.report()}")
    end_phase("kernels", failures)
    del timer

    # ---- 3. the engine at full width -----------------------------------
    failures = []
    cfg = get_config("opus-mt")
    reqs = workload(cfg.vocab_size)
    sp = SamplingParams(max_tokens=32)
    eng = build_engine(torch, cfg, mixed_plan)
    eng8 = InferenceEngine(dataclasses.replace(cfg, kv_cache_bits=8),
                           eng.params, device=eng.device, plan=eng.plan,
                           max_batch=8, block_size=16)
    eng.serve(reqs[:2], SamplingParams(max_tokens=2))        # warm-up
    torch.cuda.synchronize()
    build.reset_launches()                  # the mixed path's run starts
    greedy = {}
    for kv, e in (("kv16", eng), ("int8 KV", eng8)):
        before = dict(build.LAUNCHES)
        res = serve_checked(torch, e, kv, reqs, sp, before, failures)
        check(failures, res.cache_hit_blocks > 0,
              f"{kv}: the prefix cache found no shared block")
        greedy[kv] = res
    mixed = dict(build.LAUNCHES)            # ... and ends here
    check_compared(failures, "mixed path")
    print(f"[engine] launches on the mixed path: {mixed}")
    print("[engine] lowrank_qmm launches per decode step by shape: "
          + ", ".join(f"K{k}->N{n} x{c}"
                      for (k, n), c in lowrank_launch_shapes(cfg).items()))
    for name in build.SOURCES:
        check(failures, mixed.get(name, 0) > 0,
              f"kernel {name} was not launched on the mixed path")
    end_phase("engine", failures)

    # the quant-only baseline: every linear on quant_matmul
    failures = []
    qeng = build_engine(torch, cfg, quant_plan)
    qeng.serve(reqs[:2], SamplingParams(max_tokens=2))       # warm-up
    torch.cuda.synchronize()
    build.reset_launches()                  # the quant-only path's run starts
    res = serve_checked(torch, qeng, "kv16", reqs, sp, {}, failures)
    quant = dict(build.LAUNCHES)            # ... and ends here
    shapes = {key[1:]: c for key, c in build.LAUNCH_SHAPES.items()
              if key[0] == "quant_matmul"}
    print(f"[baseline] launches on the quant-only path: {quant}")
    print("[baseline] quant_matmul launches by shape over "
          f"{res.steps} steps: " + ", ".join(
              f"K{k}->N{n} {c} ({c / res.steps:g} a step)"
              for (k, n), c in sorted(shapes.items())))
    check(failures, quant.get("lowrank_qmm", 0) == 0,
          "lowrank_qmm launched under the quant-only plan")
    check(failures, quant.get("paged_attention", 0) > 0,
          "paged_attention was not launched on the quant-only path")
    for (k, n), per in quant_launch_shapes(cfg).items():
        check(failures, shapes.get((k, n), 0) == per * res.steps,
              f"quant_matmul K{k}->N{n}: {shapes.get((k, n), 0)} launches, "
              f"expected {per} a step x {res.steps} steps")
    check(failures, sum(shapes.values()) == quant.get("quant_matmul", 0),
          "quant_matmul launches outside the plan's linears")
    end_phase("baseline", failures)
    compare_plans(torch, {"mixed kv16": eng, "quant-only kv16": qeng}, reqs,
                  sp)
    profile_run(torch, lambda: eng.serve(reqs, sp).steps, "mixed kv16 serve")
    profile_run(torch, lambda: qeng.serve(reqs, sp).steps,
                "quant-only kv16 serve")

    # ---- sampling and speculation on the mixed plan ----------------------
    failures = []
    _, sampled = sampling_phase(torch, eng, reqs, greedy["kv16"], failures)
    end_phase("sampling", failures)
    failures = []
    speculated = speculation_phase(torch, eng, eng8, reqs, greedy["kv16"],
                                   greedy["int8 KV"], failures)
    end_phase("speculation", failures)
    failures = []
    compressed, paths, calibration = compression_phase(torch, cfg, reqs,
                                                       failures)
    end_phase("compression", failures)
    failures = []
    deployed, dse_launches = dse_phase(torch, cfg, reqs, *calibration,
                                       failures)
    end_phase("dse", failures)
    compressed.update(deployed)
    paths.update(dse_launches)
    failures = []
    rect = rectangular_phase(torch, cfg, eng, eng8, qeng, failures)
    end_phase("rectangular", failures)
    failures = []
    trained = train_phase(torch, cfg, failures)
    end_phase("train", failures)
    launches = {name: sum(path.get(name, 0)
                          for path in (mixed, quant, sampled, speculated,
                                       *paths.values(), rect, trained))
                for name in build.SOURCES}
    failures = []
    graphs_phase(torch, cfg, {"mixed kv16": eng, "mixed int8 KV": eng8,
                              "quant-only kv16": qeng}, reqs, failures)
    end_phase("graphs", failures)
    failures = []
    for name, n in tp_phase(torch, failures, {"kv16": eng,
                                              "kv8": eng8}).items():
        launches[name] += n
    end_phase("tp", failures)

    # ---- 4. card vs CPU --------------------------------------------------
    failures = []
    rng = np.random.default_rng(1)
    short = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
             for n in (16, 29, 47, 64)]
    sp8 = SamplingParams(max_tokens=8)
    sampled8 = SamplingParams(max_tokens=8, temperature=0.8, top_k=50,
                              top_p=0.9, seed=7)
    # equal lengths for generate: 29 tokens, a 32-token bucket
    rect = rng.integers(1, cfg.vocab_size, (4, 29)).astype(np.int32)
    for e in (eng, qeng):
        cpu_params = cpu_copy(e.params)
        for kv in (16, 8):
            c = dataclasses.replace(cfg, kv_cache_bits=kv)
            gpu = InferenceEngine(c, e.params, device=e.device, plan=e.plan)
            cpu = InferenceEngine(c, cpu_params, device=torch.device("cpu"),
                                  plan=e.plan)
            parity(torch, f"{e.plan.label} kv{kv}", gpu, cpu, short, sp8,
                   failures)
            generate_parity(torch, f"{e.plan.label} kv{kv}", gpu, cpu, rect,
                            sp8, failures)
            if e is eng:
                generate_parity(torch, f"{e.plan.label} kv{kv} sampled", gpu,
                                cpu, rect, sampled8, failures)
            if e is eng and kv == 16:
                parity(torch, f"{e.plan.label} kv{kv} sampled", gpu, cpu,
                       short, sampled8, failures)
                spec = DraftSpec(**SPEC)
                parity(torch, f"{e.plan.label} kv{kv} speculative",
                       InferenceEngine(c, e.params, device=e.device,
                                       plan=e.plan, speculate=spec),
                       InferenceEngine(c, cpu_params,
                                       device=torch.device("cpu"),
                                       plan=e.plan, speculate=spec),
                       short, sp8, failures)
    # the compression phase's models, compressed once on the card: the
    # CPU serves the same compressed tensors (cuSOLVER and LAPACK give
    # other singular vectors, so compressing twice would give two models)
    for label, e in compressed.items():
        cpu = InferenceEngine(cfg, cpu_copy(e.params),
                              device=torch.device("cpu"), plan=e.plan)
        parity(torch, f"{label} {e.plan.label} kv16", e, cpu, short, sp8,
               failures)
    end_phase("parity", failures)

    # ---- the mixture-of-experts layout ------------------------------------
    failures = []
    for name, n in moe_phase(torch, failures).items():
        launches[name] += n
    end_phase("moe", failures)

    # ---- the bfloat16 model dtype -------------------------------------------
    failures = []
    for name, n in bf16_phase(torch, failures).items():
        launches[name] += n
    end_phase("bf16", failures)

    # ---- gemma2-9b's local/global layers -------------------------------------
    failures = []
    for name, n in gemma2_phase(torch, failures).items():
        launches[name] += n
    end_phase("gemma2", failures)

    # ---- the Mamba layouts: falcon-mamba-7b and zamba2-2.7b ---------------
    failures = []
    deferred: list = []
    trained = mamba_train_phase(torch, failures, defer=deferred)
    end_phase("mamba-train", failures)
    failures = []
    for name, n in mamba_phase(torch, failures, trained).items():
        launches[name] += n
    end_phase("mamba", failures)
    failures = []
    join_cpu_steps(deferred, failures)      # zamba2-2.7b's, during mamba
    end_phase("mamba-train card vs CPU", failures)

    # ---- nemotron-4-340b: Dh 192, six linears a layer, the widest linears --
    failures = []
    for name, n in nemotron_phase(torch, failures).items():
        launches[name] += n
    end_phase("nemotron", failures)
    return finish(torch, kern, launches)


def finish(torch, kern, launches) -> int:
    """Print the kernels' line, the card and the result; exit code 0."""
    srcs = {"quant_matmul": ("quant_matmul.cu", "quant_matmul.py:74"),
            "lowrank_qmm": ("lowrank_qmm.cu", "lowrank_qmm.py:93"),
            "paged_attention": ("paged_attention.cu",
                                "paged_attention.py:129")}
    line = {"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{srcs[name][0]}",
        "replaces": f"src/repro/kernels/{srcs[name][1]}",
        "launches": launches[name],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for name, k in kern.items()]}
    gapped = [f"{row['name']} {key}" for row in line["kernels"]
              for key, v in row.items() if isinstance(v, HostGapped)]
    if gapped:
        raise PhaseFailed("the kernels' line would carry times that include "
                          "the host's gaps: " + ", ".join(gapped))
    print(f"kernels checked: {', '.join(kern)} "
          f"(the whole script: {time.perf_counter() - T_START:.1f} s)")
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        sys.exit(1)

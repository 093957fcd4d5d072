"""Serving CLI: a thin front end over `repro_torch.api.engine`.

Builds the engine (random weights from --seed, compressed per --plan
when given, else per the uniform --compression / --wl / --rank-fraction),
takes --batch prompts of --prompt-len tokens from the seeded Markov task
(`data.pipeline.MarkovTask`), and generates --gen tokens for each. By
default the batch runs rectangular through `InferenceEngine.generate`
(one prefill, then lockstep decode steps over a contiguous KV cache).
With --ragged the prompts are cut to different lengths (less 0, 4, 8 or
12 tokens by row) and served through the in-flight batching scheduler
(--max-batch rows, --block-size, --chunk-tokens a step, the prefix cache
unless --no-prefix-cache); --speculate K drafts K tokens a round with the
plan's cascade truncated to --draft-rank-fraction, and --stream prints
tokens as they complete through `serve_stream` (both need --ragged).
Requests are greedy unless --temperature > 0 (with --top-k / --top-p,
seeded by --seed); --eos-id and --stop end a request early. --arch takes
every name of `repro_torch.configs` (opus-mt, phi3-medium-14b,
stablelm-12b, gemma2-9b, nemotron-4-340b, deepseek-moe-16b,
mixtral-8x22b, falcon-mamba-7b, zamba2-2.7b, ...); the model's dtype is
its config's (bfloat16 at full size). gemma2-9b's local/global layers and
the Mamba archs (falcon-mamba-7b, zamba2-2.7b) run rectangular only: the
blocked KV pool refuses them, as the reference's does, so --ragged does.

  python -m repro_torch.launch.serve --arch opus-mt --compression svd \
      --wl 8 --rank-fraction 0.75
  python -m repro_torch.launch.serve --arch opus-mt --plan plan.json \
      --prompt-len 128 --gen 32 --batch 16 --max-batch 8 --kv-bits 8 \
      --ragged --temperature 0.8 --top-k 50 --top-p 0.9 --speculate 4
  python -m repro_torch.launch.serve --arch phi3-medium-14b --ragged \
      --compression quant --wl 4 --batch 8
  python -m repro_torch.launch.serve --arch gemma2-9b --compression itera \
      --wl 4 --rank-fraction 0.5 --prompt-len 128 --gen 16 --batch 8

It runs on the GPU; `--device cpu` runs the kernels' plain versions on
the CPU instead (there is no silent fallback).

--mesh N serves tensor-parallel over N rank processes started from this
command (`launch.mesh.spawn`): attention/KV heads and MLP hidden columns
split N ways, one all-reduce at each wo and down. The ranks take
cuda:0 ... cuda:N-1 over NCCL, or with --device cpu N CPU ranks over
gloo; the tokens are the single-device engine's, and rank 0 prints.
--mesh 0 (the default) is the single-device engine, as in the reference.

  python -m repro_torch.launch.serve --arch opus-mt --smoke --device cpu \
      --mesh 2 --ragged
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api.engine import (InferenceEngine, SamplingParams,
                                    TokenEvent, params_to, resolve_device)
from repro_torch.api.plan import CompressionPlan
from repro_torch.configs import get_config
from repro_torch.core.compress import CompressionConfig
from repro_torch.data.pipeline import MarkovTask
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharding import check_tp_geometry
from repro_torch.runtime.speculation import DraftSpec


async def serve_stream(engine, requests, sampling=None, **serve_kwargs):
    """Async front door over `engine.serve`: yields each `TokenEvent` as
    the serve confirms it, then the `ServeResult` as the last item.

    The serve runs unchanged on a worker thread; its `on_token` callback
    hands events to the caller's event loop with `call_soon_threadsafe`,
    so they arrive in order and at completion time, not at drain. An
    exception of the serve is raised here after the events before it.

        async for ev in serve_stream(engine, prompts, sampling):
            if isinstance(ev, TokenEvent):
                ...                     # stream ev.rid / ev.token out
            else:
                result = ev             # the closing ServeResult
    """
    import asyncio
    import threading

    loop = asyncio.get_running_loop()
    q: asyncio.Queue = asyncio.Queue()

    def on_token(ev: TokenEvent) -> None:
        loop.call_soon_threadsafe(q.put_nowait, ev)

    def run() -> None:
        try:
            res = engine.serve(requests, sampling, on_token=on_token,
                               **serve_kwargs)
        except BaseException as e:     # surface serve errors to the consumer
            loop.call_soon_threadsafe(q.put_nowait, e)
        else:
            loop.call_soon_threadsafe(q.put_nowait, res)

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    try:
        while True:
            item = await q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
            if not isinstance(item, TokenEvent):   # the result closes it
                return
    finally:
        worker.join()


def generate(params, cfg, prompts, gen_len: int, *, greedy=True, seed=0,
             device=None):
    """Back-compat helper: `gen_len` tokens for each of `prompts` from
    already-built params, greedy or sampled at temperature 1 from `seed`;
    returns the (B, gen_len) int32 array. It builds an engine on every
    call; new code holds an `InferenceEngine` and calls `.generate`."""
    dev = resolve_device(device)
    eng = InferenceEngine(cfg, params_to(params, dev), device=dev)
    return eng.generate(prompts, SamplingParams(
        max_tokens=gen_len, temperature=0.0 if greedy else 1.0,
        seed=seed)).tokens


def _stream(engine, prompts, sampling):
    """Serve through `serve_stream`, printing the first tokens and each
    request's last one; returns the ServeResult."""
    import asyncio

    async def drive():
        shown = 0
        async for ev in serve_stream(engine, prompts, sampling):
            if not isinstance(ev, TokenEvent):
                return ev
            if shown < 8 or ev.final:
                tag = " (final)" if ev.final else ""
                print(f"[stream] rid={ev.rid} #{ev.index}: {ev.token}{tag}")
            shown += 1

    return asyncio.run(drive())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="opus-mt")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's small test configuration")
    ap.add_argument("--plan", default=None,
                    help="CompressionPlan JSON (either package writes it); "
                         "overrides --compression/--wl/--rank-fraction")
    ap.add_argument("--compression", default="none",
                    choices=["none", "quant", "svd", "itera"],
                    help="uniform compression of every eligible linear "
                         "(none: serve the weights uncompressed)")
    ap.add_argument("--wl", type=int, default=8,
                    help="weight word length of --compression")
    ap.add_argument("--rank-fraction", type=float, default=0.5,
                    help="rank of svd / itera as a fraction of min(K, N)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4, help="number of requests")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="batch-row capacity of the scheduler")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV-cache block size (tokens)")
    ap.add_argument("--chunk-tokens", type=int, default=256,
                    help="per-step token budget of the scheduler, split "
                         "between prefill chunks and decode tokens")
    ap.add_argument("--ragged", action="store_true",
                    help="cut the prompts to different lengths and serve "
                         "them through the in-flight batching scheduler "
                         "(default: one rectangular batch through "
                         "generate)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="share KV blocks between requests with equal "
                         "full-block prompt prefixes (on by default; the "
                         "tokens are unchanged)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--kv-bits", type=int, default=None, choices=[8, 16],
                    help="KV pool residency: 16 = model dtype, 8 = int8 "
                         "codes with fp32 scales (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, prompts and the sampler's seed")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="self-speculative decoding: draft K tokens per "
                         "greedy decode row with the truncated cascade and "
                         "verify them with the full model in one dispatch "
                         "(the tokens are unchanged; needs a low-rank plan "
                         "to save work)")
    ap.add_argument("--draft-rank-fraction", type=float, default=0.5,
                    help="fraction of each cascade's rank the draft keeps")
    ap.add_argument("--draft-act-wl", type=int, default=None,
                    help="activation word length of the draft pass "
                         "(default: the plan's)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="<= 0: greedy; > 0 samples on the device")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus threshold in (0, 1]; 1.0 keeps all")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop a request after it emits this token id")
    ap.add_argument("--stop", action="append", default=[], metavar="IDS",
                    help="stop token sequence as comma-separated ids "
                         "(repeatable; matched inclusively on the device)")
    ap.add_argument("--stream", action="store_true",
                    help="consume the serve through serve_stream and print "
                         "tokens as they complete")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="tensor-parallel serving over N rank processes: "
                         "attention/KV heads and MLP hidden dims split N "
                         "ways, one all-reduce at each wo and down (the "
                         "tokens are unchanged); cuda:0..N-1 over NCCL, or "
                         "N CPU ranks over gloo with --device cpu")
    args = ap.parse_args(argv)
    if not args.ragged and (args.stream or args.speculate):
        ap.error("--stream and --speculate serve through the scheduler: "
                 "add --ragged")
    if args.mesh < 0:
        ap.error(f"--mesh must be >= 0, got {args.mesh}")
    if args.mesh == 0:
        return _run(None, args)
    check_tp_geometry(get_config(args.arch, smoke=args.smoke), args.mesh)
    devices = (None if args.device in (None, "cuda")
               else [args.device] * args.mesh)
    print(f"[serve] tensor-parallel over mesh (data=1, model={args.mesh})")
    return mesh_mod.spawn(_run, args.mesh, args, devices=devices)


def _run(mesh, args):
    """Build the engine (on `mesh`'s rank when given), run the requests
    and return the result; prints on the single device or rank 0."""
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    if args.plan is not None:
        plan = CompressionPlan.load(args.plan)
        say(f"[serve] {plan.summary()}")
    elif args.compression != "none":
        plan = CompressionConfig(method=args.compression, weight_wl=args.wl,
                                 rank_fraction=args.rank_fraction)
    else:
        plan = None
    speculate = None
    if args.speculate > 0:
        speculate = DraftSpec(k=args.speculate,
                              rank_fraction=args.draft_rank_fraction,
                              act_wl=args.draft_act_wl)
    engine = InferenceEngine.build(
        args.arch, plan, smoke=args.smoke, seed=args.seed,
        device=None if mesh is not None else args.device,
        verbose=mesh is None or mesh.rank == 0, max_batch=args.max_batch,
        block_size=args.block_size, chunk_tokens=args.chunk_tokens,
        prefix_cache=args.prefix_cache, kv_bits=args.kv_bits,
        speculate=speculate, mesh=mesh)
    if args.plan is None and engine.plan is not None:
        say(f"[serve] {engine.plan.summary()}")
    task = MarkovTask(engine.cfg.vocab_size, seed=args.seed)
    prompts = task.batch(0, args.batch, args.prompt_len)["tokens"].numpy()
    sampling = SamplingParams(
        max_tokens=args.gen, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, seed=args.seed, eos_id=args.eos_id,
        stop=tuple(tuple(int(t) for t in s.split(",")) for s in args.stop))
    if not args.ragged:
        res = engine.generate(prompts, sampling)
        say(f"[serve] generated {res.tokens.shape} on {engine.device} in "
            f"{res.seconds:.3f}s ({res.tokens_per_second:.1f} tok/s)")
        say("[serve] sample:", res.tokens[0][:16].tolist())
        return res
    lens = [max(4, args.prompt_len - 4 * (i % 4)) for i in range(args.batch)]
    ragged = [prompts[i, :n] for i, n in enumerate(lens)]
    res = (_stream(engine, ragged, sampling) if args.stream
           else engine.serve(ragged, sampling))
    say(f"[serve] {len(ragged)} requests (prompt lens {lens}) on "
        f"{engine.device} in {res.seconds:.3f}s: {res.steps} steps "
        f"({res.mixed_steps} mixed), {res.prefill_chunks} prefill chunks, "
        f"{res.tokens_per_second:.1f} tok/s")
    say(f"[serve] TTFT p50 {res.ttft_p50 * 1e3:.1f} ms, per-output-token "
        f"p50 {res.tpot_p50 * 1e3:.2f} ms; {res.stopped_early} stopped "
        f"early")
    if res.prefix_cache:
        say(f"[serve] prefix cache: hit rate {res.cache_hit_rate:.2f} "
            f"({res.cache_hit_blocks}/{res.cache_lookup_blocks} blocks, "
            f"{res.cache_hit_tokens} prompt tokens skipped), "
            f"{res.cache_blocks_saved} blocks saved, "
            f"{res.cache_cow_blocks} COW")
    if res.spec_k:
        say(f"[serve] speculation k={res.spec_k}: {res.accepted}/"
            f"{res.drafted} drafts accepted ({res.accept_rate:.2f}) over "
            f"{res.spec_rounds} rounds")
    say("[serve] sample:", res.outputs[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()

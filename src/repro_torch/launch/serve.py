"""Serving CLI: a thin front end over `repro_torch.api.engine`.

Builds the engine (random weights from --seed, compressed per --plan
when given, else per the uniform --compression / --wl / --rank-fraction),
then serves --batch requests of random tokens with ragged prompt
lengths (--prompt-len, less 0, 4, 8 or 12 tokens by row) through the
in-flight batching scheduler, and prints throughput and latency. Requests
are greedy unless --temperature > 0 (with --top-k / --top-p, seeded by
--seed); --eos-id and --stop end a request early; --speculate K drafts K
tokens a round with the plan's cascade truncated to
--draft-rank-fraction; --stream prints tokens as they complete through
`serve_stream`.

  python -m repro_torch.launch.serve --arch opus-mt --compression svd \
      --wl 8 --rank-fraction 0.75
  python -m repro_torch.launch.serve --arch opus-mt --plan plan.json \
      --prompt-len 128 --gen 32 --batch 16 --max-batch 8 --kv-bits 8 \
      --temperature 0.8 --top-k 50 --top-p 0.9 --speculate 4

It runs on the GPU; `--device cpu` runs the kernels' plain versions on
the CPU instead (there is no silent fallback).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api.engine import InferenceEngine, SamplingParams, TokenEvent
from repro_torch.api.plan import CompressionPlan
from repro_torch.core.compress import CompressionConfig
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
    args = ap.parse_args(argv)

    if args.plan is not None:
        plan = CompressionPlan.load(args.plan)
        print(f"[serve] {plan.summary()}")
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
        device=args.device, verbose=True, max_batch=args.max_batch,
        block_size=args.block_size, kv_bits=args.kv_bits,
        speculate=speculate)
    if args.plan is None and engine.plan is not None:
        print(f"[serve] {engine.plan.summary()}")
    rng = np.random.default_rng(args.seed)
    lens = [max(4, args.prompt_len - 4 * (i % 4)) for i in range(args.batch)]
    prompts = [rng.integers(1, engine.cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    sampling = SamplingParams(
        max_tokens=args.gen, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, seed=args.seed, eos_id=args.eos_id,
        stop=tuple(tuple(int(t) for t in s.split(",")) for s in args.stop))
    res = (_stream(engine, prompts, sampling) if args.stream
           else engine.serve(prompts, sampling))
    print(f"[serve] {len(prompts)} requests (prompt lens {lens}) on "
          f"{engine.device} in {res.seconds:.3f}s: {res.steps} steps "
          f"({res.mixed_steps} mixed), {res.prefill_chunks} prefill chunks, "
          f"{res.tokens_per_second:.1f} tok/s")
    print(f"[serve] TTFT p50 {res.ttft_p50 * 1e3:.1f} ms, per-output-token "
          f"p50 {res.tpot_p50 * 1e3:.2f} ms; prefix cache hit rate "
          f"{res.cache_hit_rate:.2f}; {res.stopped_early} stopped early")
    if res.spec_k:
        print(f"[serve] speculation k={res.spec_k}: {res.accepted}/"
              f"{res.drafted} drafts accepted ({res.accept_rate:.2f}) over "
              f"{res.spec_rounds} rounds")
    print("[serve] sample:", res.outputs[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()

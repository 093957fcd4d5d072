"""Serving CLI: a thin front end over `repro_torch.api.engine`.

Builds the engine (random weights from --seed, compressed per --plan when
given), then serves --batch greedy requests of random tokens with ragged
prompt lengths (--prompt-len, less 0, 4, 8 or 12 tokens by row) through
the in-flight batching scheduler, and prints throughput and latency.

  python -m repro_torch.launch.serve --arch opus-mt --plan plan.json \
      --prompt-len 128 --gen 32 --batch 16 --max-batch 8 --kv-bits 8

It runs on the GPU; `--device cpu` runs the kernels' plain versions on
the CPU instead (there is no silent fallback).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api.engine import InferenceEngine, SamplingParams
from repro_torch.api.plan import CompressionPlan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="opus-mt")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's small test configuration")
    ap.add_argument("--plan", default=None,
                    help="CompressionPlan JSON (either package writes it); "
                         "without it the weights are served uncompressed")
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    plan = CompressionPlan.load(args.plan) if args.plan else None
    if plan is not None:
        print(f"[serve] {plan.summary()}")
    engine = InferenceEngine.build(
        args.arch, plan, smoke=args.smoke, seed=args.seed,
        device=args.device, verbose=True, max_batch=args.max_batch,
        block_size=args.block_size, kv_bits=args.kv_bits)
    rng = np.random.default_rng(args.seed)
    lens = [max(4, args.prompt_len - 4 * (i % 4)) for i in range(args.batch)]
    prompts = [rng.integers(1, engine.cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    res = engine.serve(prompts, SamplingParams(max_tokens=args.gen))
    print(f"[serve] {len(prompts)} requests (prompt lens {lens}) on "
          f"{engine.device} in {res.seconds:.3f}s: {res.steps} steps "
          f"({res.mixed_steps} mixed), {res.prefill_chunks} prefill chunks, "
          f"{res.tokens_per_second:.1f} tok/s")
    print(f"[serve] TTFT p50 {res.ttft_p50 * 1e3:.1f} ms, per-output-token "
          f"p50 {res.tpot_p50 * 1e3:.2f} ms; prefix cache hit rate "
          f"{res.cache_hit_rate:.2f}")
    print("[serve] sample:", res.outputs[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Run some of chip_smoke.py's checks on one NVIDIA GPU, for quicker turns
than the whole script: phase 2's bf16 kernel rows, its rows past
lowrank_qmm's R 1024, its Mamba linears and the tensor-parallel per-rank
shapes, then the gemma2, mamba-train, mamba, bf16, nemotron and tp
phases (or a subset).

    python3 tools/smoke_phases.py [--phases bf16-kernels,large-ranks,\
        mamba-kernels,tp-kernels,gemma2,mamba-train,mamba,bf16,nemotron,tp]

Later phases check their lowrank_qmm launches against what the kernel
phases compared, so keep those first. The mamba phase compresses the
weights the mamba-train phase trained when that ran before it, else
seed-0 weights. Prints each part's failures and
seconds, and the card's name and power limit; exits 1 if any failed.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
PHASES = ("bf16-kernels", "large-ranks", "mamba-kernels", "tp-kernels",
          "gemma2", "mamba-train", "mamba", "bf16", "nemotron", "tp")
KERNEL_PHASES = ("bf16-kernels", "large-ranks", "mamba-kernels",
                 "tp-kernels")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import build

    print(build.build())
    build_failures: list = []
    cs.print_ptxas(build_failures)
    timer = cs.Timer(torch)
    runs = {"bf16-kernels": lambda f: cs.check_bf16_kernels(torch, f),
            "large-ranks": lambda f: cs.check_large_ranks(torch, f),
            "mamba-kernels": lambda f: cs.check_mamba_kernels(torch, timer,
                                                              f),
            "tp-kernels": lambda f: cs.check_tp_kernels(torch, f),
            "mamba-train": lambda f: trained.update(
                cs.mamba_train_phase(torch, f, defer=deferred)),
            "mamba": lambda f: cs.mamba_phase(torch, f, trained or None),
            "gemma2": lambda f: cs.gemma2_phase(torch, f),
            "bf16": lambda f: cs.bf16_phase(torch, f),
            "nemotron": lambda f: cs.nemotron_phase(torch, f),
            "tp": lambda f: cs.tp_phase(torch, f)}
    trained: dict = {}
    deferred: list = []     # mamba-train's CPU steps, joined at the end
    failed = bool(build_failures)
    build.reset_launches()
    for name in args.phases.split(","):
        failures: list = []
        t0 = time.perf_counter()
        runs[name](failures)
        if name in KERNEL_PHASES:
            cs.note_compared()
        print(f"[{name}] failures {failures}; "
              f"{time.perf_counter() - t0:.1f} s")
        failed |= bool(failures)
    failures = []
    cs.join_cpu_steps(deferred, failures)
    if deferred:
        print(f"[mamba-train card vs CPU] failures {failures}")
    failed |= bool(failures)
    print(f"[timer] {timer.report()}")
    print(cs.card_line())
    return int(failed)


if __name__ == "__main__":
    sys.exit(main())

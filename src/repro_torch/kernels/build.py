"""Build and load the port's CUDA kernels.

Each source under `csrc/` compiles with `nvcc` into its own shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). Libraries go to `build/kernels/` at the root of the
checkout, named by a hash of their sources and flags, so an edited source
rebuilds and an unchanged one is reused. `build()` starts one `nvcc` per
missing library, all at once; `load()` builds on first use.

Every wrapper counts its launches in `LAUNCHES` (one per kernel launch,
nowhere else), which is how a run shows that the serving path went
through the kernels; `quant_matmul` also counts them by (K, N) in
`LAUNCH_SHAPES`, which shows which linears a plan sent through it, and
`lowrank_qmm` by its (padded) rank R in `LAUNCH_RANKS`, which shows the
speculative draft's truncated cascades ran, and by (bm, K, R, N,
w1_packed, w2_packed, E) in `LAUNCH_SHAPES` (bm the tile rows its
partition chose, E the experts of a stacked launch, 1 for one matrix),
which shows which of the kernel's code paths a run took.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {
    "quant_matmul": ("quant_matmul.cu", "common.cuh", "async_copy.cuh"),
    "lowrank_qmm": ("lowrank_qmm.cu", "common.cuh", "async_copy.cuh"),
    "paged_attention": ("paged_attention.cu", "async_copy.cuh"),
}
# no --use_fast_math: the integer kernels need IEEE division and rintf.
# --fmad=false keeps a*b+c as two roundings, as the plain versions'
# elementwise scale epilogues do (their float64 matrix products may fuse).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90

LAUNCHES: collections.Counter = collections.Counter()
LAUNCH_SHAPES: collections.Counter = collections.Counter()
LAUNCH_RANKS: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCH_SHAPES.clear()
    LAUNCH_RANKS.clear()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> pathlib.Path:
    """The compiler's output of the last build of `name` (ptxas prints
    each kernel's registers, spills and shared memory there)."""
    return lib_path(name).with_suffix(".log")


def build(names=None) -> dict[str, float]:
    """Compile every missing library of `names` (default: all), one nvcc
    process per source, started together. Returns seconds per library
    built; raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    secs, errors = {}, []
    for n, (p, tmp, t0) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        log_path(n).write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n} (exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of kernel `name`, built on first use, with `argtypes`
    and `restype` set from `signatures` ({function: (restype, argtypes)})."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, (res, args) in signatures.items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = list(args)
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count

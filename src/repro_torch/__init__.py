"""PyTorch/CUDA port of the ITERA-LLM serving path for NVIDIA Hopper.

A second package beside the JAX reference (`repro`), mirroring its
layout. It imports torch, numpy and the standard library only: nothing of
jax and nothing of `repro` (it keeps its own copies of the host-side code
it needs). Every Pallas kernel of the reference has a hand-written CUDA
C++ counterpart under `kernels/csrc/`, launched through ctypes on CUDA
tensors; on CPU tensors each wrapper runs its plain PyTorch version.

Entry points (`api.engine.InferenceEngine.build`, `launch.serve`) run on
`cuda` unless the caller passes `device="cpu"`, and raise when no GPU is
present and no CPU device was asked for.
"""

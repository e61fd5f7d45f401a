"""PyTorch/CUDA port of the partial-sum reproduction.

The planner (`repro_torch.plan`) chooses each layer's (m, n) channel
partition or GEMM block; the kernels (`repro_torch.kernels`) run it on an
NVIDIA Hopper card through hand-written CUDA C++ (``kernels/csrc``), and on
the CPU through plain PyTorch versions of the same loop nests. The dense
decoder-only LMs (`repro_torch.configs`, `repro_torch.models`) serve through
`repro_torch.launch.serve`, with their attention in the flash kernel.

The package imports ``torch`` and never ``jax`` or the ``repro`` package: it
keeps its own copy of everything it needs.
"""

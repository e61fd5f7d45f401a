"""Kernels: hand-written CUDA C++ for Hopper (``csrc/``) behind PyTorch
wrappers, each with a plain PyTorch version for CPU tensors.

  psum_matmul   active / passive blocked GEMM   (csrc/psum_matmul.cu)
  conv2d_psum   channel-partitioned conv        (csrc/conv2d_psum.cu)
  flash_attention  online-softmax attention     (csrc/flash_attention.cu)
  conv_network  the planned whole-network runner over conv2d_psum

Importing this package builds nothing: a kernel is compiled at its first
launch, or all at once by ``_build.build()``.
"""

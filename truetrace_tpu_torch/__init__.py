"""TrueTrace-TPU ported to PyTorch and CUDA (NVIDIA Hopper).

The JAX package `truetrace_tpu` beside this one is the reference; this
package mirrors its subpackages and module names (core, build, scene,
kernels, integrate, post, renderer) so each counterpart is easy to find.
It imports torch and numpy and never JAX. The CUDA kernels under
kernels/csrc are built with nvcc at first use (kernels/_cuda.py); on CPU
tensors every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

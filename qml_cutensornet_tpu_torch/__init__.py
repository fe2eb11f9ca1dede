"""qml_cutensornet_tpu_torch: the PyTorch / CUDA port of ``qml_cutensornet_tpu``.

The JAX package beside this one is the reference; every module here mirrors
the module of the same name there and is held against it by the
``tests/test_torch_*.py`` suite. This package imports ``torch`` and never
``jax`` or ``qml_cutensornet_tpu``.

Complex arithmetic uses native ``complex64`` / ``complex128`` tensors. The
two hot factorizations of the MPS engine run as hand-written CUDA kernels for
Hopper (``csrc/``): the fused subspace split (``ops/split.py``) and the fused
Q+R orthonormalizer (``ops/orth.py``). On CPU tensors their plain PyTorch
versions run instead; a CUDA tensor always reaches the kernel or an error.

Importing this package imports nothing else; use the submodules, e.g.
``qml_cutensornet_tpu_torch.models.gram.build_kernel_matrix``.
"""

__version__ = "0.1.0"

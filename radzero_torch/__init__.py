"""PyTorch + CUDA port of radzero_tpu for NVIDIA Hopper (H100).

The JAX package ``radzero_tpu`` stays the reference; every module here
has a counterpart there with the same file name and job, and the tests
(``tests/test_torch_*.py``) hold each one against it.

One switch picks between a hand-written kernel and its plain PyTorch
twin: the device of the tensor handed to the kernel wrapper. A CPU
tensor runs the twin; a CUDA tensor launches the kernel (built from
``radzero_torch/ops/csrc`` at first use) or raises. Nothing here imports
``jax`` or ``radzero_tpu``.
"""

__version__ = "0.1.0"

"""Device switch and operand checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

# operand dtype -> the ``dtype`` code of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cuda(t: torch.Tensor) -> bool:
    """The one switch: False for a CPU tensor (plain twin), True for a
    CUDA tensor (kernel); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain twin for device {t.device}")


def tracked(*tensors) -> bool:
    """Whether autograd would record an op on any of ``tensors`` now."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def needed(ctx, grads) -> tuple:
    """``grads`` with None where autograd asked for no gradient."""
    return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def forbid_grad(name: str, missing: str, *tensors) -> None:
    """Raise when a forward-only kernel wrapper is handed an operand that
    autograd tracks. The wrappers write into fresh outputs outside the
    tape, so the result would carry no ``grad_fn`` and the gradient would
    stop there in silence. ``missing`` names what provides the backward.
    There is no fallback to the eager ops or the plain twin."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name} is forward-only and an operand requires a gradient: {missing}. "
            "Call it under torch.no_grad() for a frozen module, or take the "
            "differentiable eager path."
        )


def check_operands(name: str, x: torch.Tensor, **named) -> int:
    """Validate the kernel operands and return the dtype code.

    ``x`` fixes the device and dtype (fp32 or bf16). Each keyword is
    ``(expected_shape, tensor)``; every tensor must match x's device and
    dtype, have that shape, be contiguous and start on a 16-byte boundary
    (the kernels load 16-byte vectors).
    """
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: operands must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")
    for arg, (shape, t) in named.items():
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(
                f"{name}: {arg} is {t.dtype} on {t.device}, expected {x.dtype} on {x.device}"
            )
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    return DTYPE_CODES[x.dtype]

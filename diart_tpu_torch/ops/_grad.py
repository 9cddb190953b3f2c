"""Gradients of the hand-written kernels.

None of the JAX package's Pallas kernels has a backward kernel: each is
wrapped in a ``jax.custom_vjp`` whose backward differentiates the kernel's
reference formulation. The port does the same with a
``torch.autograd.Function`` per kernel: its forward launches the kernel
and saves the raw inputs, its backward recomputes the plain PyTorch version
under ``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it
(:func:`plain_vjp`).

Prepared operands (a kernel's layout of its parameters, made once per
model) are cut off from autograd, so a call that trains takes the raw
parameters; operands that carry tensors which require a gradient are
refused (:func:`refuse_trained_operands`) rather than silently detached.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch

__all__ = ["plain_vjp", "refuse_trained_operands", "wants_grad"]


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records this call: grad mode is on and one of
    ``tensors`` requires a gradient."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_trained_operands(operands: Iterable, what: str) -> None:
    """Raise ``TypeError`` where autograd records this call and prepared
    ``operands`` hold a tensor that requires a gradient: the kernel's layout
    would detach it. (Operands held under ``torch.no_grad()`` may alias a
    parameter, and then require a gradient; a call without grad mode takes
    them.)"""
    if wants_grad(*(t for t in operands if isinstance(t, torch.Tensor))):
        raise TypeError(
            f"{what} hold tensors that require a gradient; prepared operands are cut off from "
            f"autograd, so pass the raw parameters to train through the kernel"
        )


def plain_vjp(ctx, reference: Callable, grads: Sequence[torch.Tensor]) -> Tuple:
    """The backward of a kernel's ``autograd.Function``: the gradients of
    ``reference(*ctx.saved_tensors)`` against the cotangents ``grads``, one
    for each saved input (``None`` where autograd needs none). The saved
    tensors are the Function's first inputs, in order."""
    inputs = ctx.saved_tensors
    needs = ctx.needs_input_grad[: len(inputs)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
        outputs = reference(*leaves)
        outputs = outputs if isinstance(outputs, tuple) else (outputs,)
        wanted = [leaf for leaf, need in zip(leaves, needs) if need]
        got = iter(torch.autograd.grad(outputs, wanted, grads, allow_unused=True) if wanted else ())
    return tuple(next(got) if need else None for need in needs)

"""Autograd for the kernels' custom ops: each op's backward rule (a plain
function of tensors in ``ref.py``) registered twice over.

``torch.library.register_autograd`` makes the op itself differentiable under
``torch.autograd``; ``torch.func`` transforms (``vjp``, ``grad``) do not take
an op registered that way, so :func:`differentiable` also returns a
``torch.autograd.Function`` over the op with the same ``setup_context`` and
``backward`` (its vmap rule runs the op under vmap, which the op's own vmap
rule takes). The wrappers call the op directly when no gradient is wanted
(:func:`needs_grad`), and the Function otherwise. Either way the forward is
the kernel.
"""
from __future__ import annotations

from typing import Callable

import torch


def differentiable(op, setup_context: Callable, backward: Callable) -> type:
    """Register ``backward`` on the custom op ``op`` and return the
    ``autograd.Function`` that applies ``op`` under the same rule."""
    op.register_autograd(backward, setup_context=setup_context)
    name = op._name.split("::")[-1]
    return type(f"{name}_function", (torch.autograd.Function,), {
        "forward": staticmethod(lambda *args: op(*args)),
        "setup_context": staticmethod(setup_context),
        "backward": staticmethod(backward),
        "generate_vmap_rule": True,
    })


def needs_grad(*tensors) -> bool:
    """Is a gradient wanted of any of ``tensors`` (None entries skipped)?"""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)

"""The kernels' custom ops: each op defined with its CUDA kernel, and its
backward rule (a plain function of tensors in ``ref.py``) registered twice
over.

:func:`cuda_op` defines an op from its kernel function and registers that
function as the op's CUDA implementation, as it is.
``torch.library.custom_op`` would wrap it in a lazy ``torch._dynamo.disable``
instead, whose first call imports ``torch._dynamo`` and the compiler stack
under it (some 840 modules): seconds of a server's set-up spent on a
compiler the port never runs.

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

_libs: list = []   # the ops' libraries: an op lives as long as its library


def cuda_op(qualname: str) -> Callable:
    """Decorator: define the op ``qualname`` (``"namespace::name"``) with the
    decorated function's schema (``torch.library.infer_schema``, mutating
    nothing), register the function as its CUDA kernel, and return the op
    (its default ``OpOverload``). Fake and vmap rules are registered on
    ``qualname`` with ``torch.library.register_fake`` and ``register_vmap``."""
    namespace, name = qualname.split("::")

    def define(fn: Callable):
        lib = torch.library.Library(namespace, "FRAGMENT")
        _libs.append(lib)
        lib.define(name + torch.library.infer_schema(fn, mutates_args=()))
        lib.impl(name, fn, "CUDA")
        return getattr(getattr(torch.ops, namespace), name).default

    return define


def differentiable(op, setup_context: Callable, backward: Callable) -> type:
    """Register ``backward`` on the custom op ``op`` and return the
    ``autograd.Function`` that applies ``op`` under the same rule."""
    torch.library.register_autograd(op, backward, setup_context=setup_context)
    name = op.__name__.split(".")[0]
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

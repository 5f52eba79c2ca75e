"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

The math is the reference's, op for op, in f32: clipping by the global norm,
``step`` counted from 1, bias corrections ``1 - b**step``, the update cast
to the parameter's dtype before it is added in f32 and cast back. The state
is ``{"mu", "nu", "step"}``: f32 moments over the same tree as the params
and a 0-dim int32 step on the params' device. Everything the step does is a
tensor op on that device (no ``.item()``, no host scalar tensor), so an
update can be captured in a CUDA graph and replayed with the step advancing
on the card.

Two ways to apply it. ``update`` is the reference's functional form:
``(grads, state, params) -> (updates, new_state, metrics)``, then
:func:`apply_updates`. ``update_`` writes the new moments, step and params
into the given tensors (and scales the given grads in place when clipping):
the counterpart of the reference launcher's ``donate_argnums=(0, 1)``, which
keeps one copy of params and moments (a functional update of qwen2.5-3b in
f32 would hold a second 37 GB). Both compute the same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

Params = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple]        # (g, state, p) -> (u, state, m)
    update_: Callable[[Params, Any, Params], dict]       # in place; -> metrics


def _leaves_like(spec, tree) -> list:
    """The leaves of ``tree``, which must have the tree structure ``spec``."""
    leaves, tspec = pytree.tree_flatten(tree)
    if tspec != spec:
        raise ValueError(f"tree structure {tspec} does not match the grads' {spec}")
    return leaves


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pytree.tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    n = global_norm(grads)
    scale = _clip_scale(n, max_norm)
    return pytree.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), n


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        leaves = pytree.tree_leaves(params)
        device = leaves[0].device if leaves else None
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {
            "mu": pytree.tree_map(zeros, params),
            "nu": pytree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
        }

    def leaf(g, m, v, p, c1, c2, lr_t):
        gf = g.float()
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf * gf
        mh = m / c1
        vh = v / c2
        step_ = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        return (-lr_t * step_).to(p.dtype), m, v

    def schedule(state):
        step = state["step"] + 1
        stepf = step.float()
        return (step, lr_fn(step), 1.0 - torch.pow(b1, stepf),
                1.0 - torch.pow(b2, stepf))

    def update(grads, state, params):
        if grad_clip:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = global_norm(grads)
        step, lr_t, c1, c2 = schedule(state)
        flat_g, spec = pytree.tree_flatten(grads)
        flat_m = _leaves_like(spec, state["mu"])
        flat_v = _leaves_like(spec, state["nu"])
        flat_p = _leaves_like(spec, params)
        out = [leaf(g, m, v, p, c1, c2, lr_t)
               for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p)]
        updates = pytree.tree_unflatten([o[0] for o in out], spec)
        new_state = {
            "mu": pytree.tree_unflatten([o[1] for o in out], spec),
            "nu": pytree.tree_unflatten([o[2] for o in out], spec),
            "step": step,
        }
        return updates, new_state, {"grad_norm": gnorm, "lr": lr_t}

    @torch.no_grad()
    def update_(grads, state, params):
        flat_g, spec = pytree.tree_flatten(grads)
        gnorm = global_norm(flat_g)
        if grad_clip:
            scale = _clip_scale(gnorm, grad_clip)
            for g in flat_g:
                g.copy_((g.float() * scale).to(g.dtype))
        step, lr_t, c1, c2 = schedule(state)
        for g, m, v, p in zip(flat_g, _leaves_like(spec, state["mu"]),
                              _leaves_like(spec, state["nu"]), _leaves_like(spec, params)):
            u, m_new, v_new = leaf(g, m, v, p, c1, c2, lr_t)
            m.copy_(m_new)
            v.copy_(v_new)
            p.copy_((p.float() + u.float()).to(p.dtype))
        state["step"].copy_(step)
        return {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init=init, update=update, update_=update_)


def apply_updates(params, updates):
    return pytree.tree_map(
        lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)

"""Kernel substrate registry: ``(op, mode)`` -> implementation.

Port of ``repro.kernels.registry``. Every op of ``ops.py`` resolves its
implementation here. The substrates:

* ``cuda`` — the hand-written Hopper kernels (``csrc/*.cu``); they take
  CUDA tensors only, and asking for them with CPU tensors raises;
* ``ref``  — the plain PyTorch versions (``ref.py``), on any device.

``auto`` (the default) is a resolution rule, not a substrate: it picks
``cuda`` when the op's input tensors lie on a CUDA device and ``ref``
otherwise, so the choice is fixed by where the data lives. The env
override ``REPRO_TORCH_KERNELS`` is validated at import, so a typo fails
at process start. Replay pins the mode once at lowering time through the
thread-local :func:`kernel_mode_scope`, as in the reference.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, Iterator

import torch

MODES = ("auto", "cuda", "ref")
SUBSTRATES = ("cuda", "ref")      # concrete (non-auto) modes
_ENV_VAR = "REPRO_TORCH_KERNELS"

_lock = threading.Lock()
_impls: dict[tuple[str, str], Callable[..., Any]] = {}


# ---------------------------------------------------------------- mode state

def validate_mode(mode: str) -> str:
    """Return ``mode`` if legal, else raise with the full legal set."""
    if mode not in MODES:
        raise ValueError(
            f"invalid kernel mode {mode!r}: expected one of {MODES} "
            f"(set via set_kernel_mode() or the {_ENV_VAR} env var)")
    return mode


def _env_mode() -> str:
    raw = os.environ.get(_ENV_VAR, "auto")
    try:
        return validate_mode(raw)
    except ValueError as e:
        raise ValueError(f"bad {_ENV_VAR} environment variable: {e}") from None


# Validated eagerly at import: a bogus REPRO_TORCH_KERNELS fails here.
_mode: str = _env_mode()

# Scope overrides are per-thread, as in the reference: a server's
# dispatcher thread pinned to one substrate cannot race another thread's.
_scope = threading.local()


def set_kernel_mode(mode: str) -> None:
    """Set the process-wide substrate mode (validated immediately)."""
    global _mode
    _mode = validate_mode(mode)


def kernel_mode() -> str:
    """The effective mode on this thread, possibly ``"auto"``."""
    return getattr(_scope, "mode", None) or _mode


def resolved_mode(mode: str | None = None,
                  device: torch.device | None = None) -> str:
    """Resolve ``mode`` (default: the effective mode) for tensors on ``device``.

    ``"auto"`` means the CUDA kernels for CUDA tensors and the plain
    versions elsewhere; with no ``device`` it stays ``"auto"``.
    """
    mode = kernel_mode() if mode is None else validate_mode(mode)
    if mode != "auto" or device is None:
        return mode
    return "cuda" if torch.device(device).type == "cuda" else "ref"


@contextlib.contextmanager
def kernel_mode_scope(mode: str) -> Iterator[None]:
    """Pin the mode for a dynamic extent on this thread (always restores)."""
    prev = getattr(_scope, "mode", None)
    _scope.mode = validate_mode(mode)
    try:
        yield
    finally:
        _scope.mode = prev


# ----------------------------------------------------------------- registry

def register(op: str, mode: str, fn: Callable[..., Any]) -> Callable[..., Any]:
    """Register ``fn`` as ``op``'s implementation under substrate ``mode``."""
    if mode not in SUBSTRATES:
        raise ValueError(
            f"cannot register mode {mode!r} for op {op!r}: expected one of "
            f"{SUBSTRATES} ('auto' is a resolution rule, not a substrate)")
    with _lock:
        _impls[(op, mode)] = fn
    return fn


def _device_of(args: tuple) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise TypeError("kernel ops need at least one tensor argument")


def resolve(op: str, device: torch.device,
            mode: str | None = None) -> Callable[..., Any]:
    """The implementation of ``op`` for tensors on ``device`` under ``mode``."""
    concrete = resolved_mode(mode, device)
    if concrete == "cuda" and device.type != "cuda":
        raise ValueError(
            f"kernel mode 'cuda' asked for op {op!r} on {device.type} tensors: "
            f"the CUDA kernels take CUDA tensors only (use 'auto' or 'ref')")
    with _lock:
        impl = _impls.get((op, concrete))
        known = sorted({k[0] for k in _impls})
    if impl is None:
        raise KeyError(f"no implementation of {op!r} for mode {concrete!r}; "
                       f"registered ops: {known}")
    return impl


def dispatch(op: str, *args: Any, mode: str | None = None, **kwargs: Any) -> Any:
    """Resolve by the first tensor argument's device and call."""
    return resolve(op, _device_of(args), mode)(*args, **kwargs)


def ops() -> list[str]:
    """Sorted list of registered op names."""
    with _lock:
        return sorted({k[0] for k in _impls})

"""Kernel dispatch registry: named ops with ``ref`` / ``cuda``
implementations, chosen by the device of the tensors they get.

Counterpart of ``repro.kernels.registry``.  Every kernel package
registers its implementations on a :class:`KernelOp` (``kernel_op(name)``
is get-or-create), and callers go through the op object —
``op(*args, impl=None)``.  The tensors' device alone picks the
implementation: ``cuda`` for CUDA tensors, ``ref`` for CPU tensors.  An
explicit ``impl=`` may name it, and must then agree: ``cuda`` on a CPU
tensor raises, and so does ``ref`` on a CUDA tensor.  There is no
fallback from one to the other — a CUDA tensor goes through the kernel or
the call raises.  (Callers that want the plain version on the card call
the ``ref`` module's function directly, as ``chip_smoke.py`` does to
compare.)  The JAX package's process and environment overrides have
nothing to choose between while each device has one implementation; they
come back with a second one for CUDA tensors (Triton).

*Strategies* (:class:`KernelStrategy`) are named algorithm knobs within
an op that every implementation honours, resolved the same way:
explicit argument > process override > own env var > auto callback.

Dispatcher ops: each kernel is also a ``torch.library`` op,
``torch.ops.repro_torch.<name>`` (:meth:`KernelOp.define`), whose CPU
kernel is the ``ref`` implementation and whose CUDA kernel is the
``cuda`` one, with a fake (shape) implementation, so that a fake or
``meta`` tensor passes through the op as one call: the dry-run
(``repro_torch.launch.dryrun``) traces the card's route that way and
counts each call at the op's registered cost (:func:`op_cost`: the
flops by dtype and the bytes one call must move, from its shapes only).
:meth:`KernelOp.__call__` sends only fake and ``meta`` tensors through
the dispatcher op; tensors that hold data go straight to the resolved
implementation, which saves the host the dispatcher's boxed call on
every launch of an eager, host-bound serving step.

Dispatch log: the JAX log appends once per trace; in eager PyTorch every
call dispatches, so the log here is a bounded ``deque`` of the most
recent ``(name, choice)`` entries, beside per-entry counters that count
every call.
"""

from __future__ import annotations

import collections
import os
from contextlib import contextmanager
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = [
    "IMPLS", "LOG_MAXLEN", "KernelOp", "kernel_op", "get_op",
    "list_ops", "resolve_impl",
    "dispatch_log", "dispatch_counts", "last_dispatch",
    "reset_dispatch_log", "KernelStrategy", "kernel_strategy",
    "get_strategy", "list_strategies", "set_default_strategy",
    "use_strategy", "op_cost",
]

IMPLS = ("ref", "cuda")
LOG_MAXLEN = 4096

_ops: dict[str, "KernelOp"] = {}
_log: collections.deque[tuple[str, str]] = collections.deque(maxlen=LOG_MAXLEN)
_counts: collections.Counter[tuple[str, str]] = collections.Counter()
_strategies: dict[str, "KernelStrategy"] = {}
_costs: dict[str, Callable] = {}
NAMESPACE = "repro_torch"
_lib = None         # the namespace's torch.library.Library
_default_strategies: dict[str, str] = {}


def _record(name: str, choice: str) -> None:
    _log.append((name, choice))
    _counts[(name, choice)] += 1


def _is_abstract(args, kwargs) -> bool:
    """Whether the call's tensors hold no data (fake or ``meta``)."""
    return any(isinstance(a, FakeTensor) or (isinstance(a, torch.Tensor)
                                             and a.is_meta)
               for a in (*args, *kwargs.values()))


def _device_of(args, kwargs) -> torch.device:
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device
    raise TypeError("a kernel op needs at least one tensor argument")


class KernelOp:
    """One named op and its registered implementations."""

    def __init__(self, name: str):
        self.name = name
        self.impls: dict[str, Callable] = {}
        self.dispatcher_op = None

    def define(self, schema: str, fake: Callable, cost: Callable) -> None:
        """Register the op with the dispatcher as ``repro_torch::<name>``
        (``schema``: its arguments and results, as ``torch.library``
        writes them): the ``ref`` impl its CPU kernel, the ``cuda`` impl
        its CUDA kernel, ``fake`` its shape function.  ``cost(*args,
        **kwargs) -> (flops_by_dtype, bytes)`` is what one call costs
        (see :func:`op_cost`).  The kernels look the impls up at each
        call, so an impl registered later (a test's wrapper) is the one
        that runs.  (A ``torch.library.Library`` op, not a
        ``torch.library.custom_op``: the latter's first call imports
        ``torch._dynamo`` and ``DTensor``: ~2 s a process on a CPU host,
        ~7 s on an H100 host, which every launcher process paid.)"""
        global _lib
        if _lib is None:
            _lib = torch.library.Library(NAMESPACE, "DEF")
        _lib.define(self.name + schema)
        for impl, key in (("ref", "CPU"), ("cuda", "CUDA")):
            _lib.impl(self.name, self._kernel(impl), key)
        torch.library.register_fake(f"{NAMESPACE}::{self.name}", fake,
                                    lib=_lib)
        self.dispatcher_op = getattr(getattr(torch.ops, NAMESPACE), self.name)
        _costs[self.name] = cost

    def _kernel(self, impl: str) -> Callable:
        def run(*args, **kwargs):
            return self.impls[impl](*args, **kwargs)
        return run

    def impl(self, impl_name: str) -> Callable:
        """Decorator: register ``fn`` as the ``impl_name`` implementation."""
        def deco(fn: Callable) -> Callable:
            self.register_impl(impl_name, fn)
            return fn
        return deco

    def register_impl(self, impl_name: str, fn: Callable) -> None:
        if impl_name not in IMPLS:
            raise ValueError(
                f"impl must be one of {IMPLS}, got {impl_name!r}")
        self.impls[impl_name] = fn

    def __call__(self, *args, impl: str | None = None, **kwargs):
        if _is_abstract(args, kwargs):
            # a fake or meta tensor (a dry-run's trace): the dispatcher op
            # runs the shape function, one op of the card's route
            return self.dispatcher_op(*args, **kwargs)
        choice = resolve_impl(self.name, impl, _device_of(args, kwargs))
        _record(self.name, choice)
        return self.impls[choice](*args, **kwargs)

    def __repr__(self) -> str:
        return f"KernelOp({self.name!r}, impls={sorted(self.impls)})"


def kernel_op(name: str) -> KernelOp:
    """Get-or-create the op named ``name``."""
    if name not in _ops:
        _ops[name] = KernelOp(name)
    return _ops[name]


def get_op(name: str) -> KernelOp:
    if name not in _ops:
        raise KeyError(f"unknown kernel op {name!r}; "
                       f"registered: {sorted(_ops)}")
    return _ops[name]


def list_ops() -> list[str]:
    return sorted(_ops)


def op_cost(name: str, *args, **kwargs) -> tuple[dict[str, float], float]:
    """What one call of the kernel op ``name`` on these arguments (real,
    fake or ``meta`` tensors) costs, from their shapes only: ``({dtype
    name: flops}, bytes)``, the flops it does and the bytes it must move
    (each input read once, each output written once), the same terms as
    the bound ``chip_smoke.py`` reckons for the kernel, taken at the most
    the shapes allow where the work depends on the data."""
    if name not in _costs:
        raise KeyError(f"kernel op {name!r} has no registered cost")
    return _costs[name](*args, **kwargs)


def resolve_impl(op_name: str, requested: str | None = None,
                 device: torch.device | str = "cpu") -> str:
    """The implementation a call to ``op_name`` on tensors of ``device``
    runs; ``requested`` (an explicit ``impl=``) must agree with it."""
    op = get_op(op_name)
    if requested is not None and requested not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {requested!r}")
    dev_type = torch.device(device).type
    choice = "cuda" if dev_type == "cuda" else "ref"
    if requested is not None and requested != choice:
        raise RuntimeError(
            f"op {op_name!r}: impl {requested!r} cannot run on {dev_type} "
            f"tensors ('cuda' takes CUDA tensors, 'ref' takes CPU tensors; "
            f"there is no fallback between them)")
    if choice not in op.impls:
        raise KeyError(f"op {op_name!r} has no {choice!r} impl "
                       f"(has: {sorted(op.impls)})")
    return choice


# ----------------------------------------------------------- strategies --

class KernelStrategy:
    """One named algorithm knob shared by every implementation of an op.

    ``choices`` is the closed set of algorithm names; ``env_var`` (if
    given) is a per-knob override; ``auto`` receives the call-site context
    kwargs (e.g. ``n_candidates=``) and returns the data-dependent default.
    """

    def __init__(self, name: str, choices: tuple[str, ...],
                 env_var: str | None = None,
                 auto: Callable[..., str] | None = None):
        self.name = name
        self.choices = tuple(choices)
        self.env_var = env_var
        self.auto = auto

    def resolve(self, requested: str | None = None, **ctx) -> str:
        """Resolve which algorithm a call should use; logged like an impl
        dispatch (as ``(strategy_name, choice)``)."""
        choice = None
        if requested is not None:
            self._validate(requested, "explicit strategy")
            choice = requested
        if choice is None:
            choice = _default_strategies.get(self.name)
        if choice is None and self.env_var:
            env = os.environ.get(self.env_var) or None
            if env is not None:
                self._validate(env, f"${self.env_var}")
                choice = env
        if choice is None and self.auto is not None:
            choice = self.auto(**ctx)
            self._validate(choice, f"{self.name} auto-select")
        if choice is None:
            choice = self.choices[0]
        _record(self.name, choice)
        return choice

    def _validate(self, choice: str, source: str) -> None:
        if choice not in self.choices:
            raise ValueError(f"{source} for {self.name!r} must be one of "
                             f"{self.choices}, got {choice!r}")

    def __repr__(self) -> str:
        return f"KernelStrategy({self.name!r}, choices={self.choices})"


def kernel_strategy(name: str, choices: tuple[str, ...] | None = None,
                    env_var: str | None = None,
                    auto: Callable[..., str] | None = None
                    ) -> KernelStrategy:
    """Get-or-create the strategy knob named ``name`` (``"<op>.<knob>"``)."""
    if name not in _strategies:
        if choices is None:
            raise KeyError(f"unknown kernel strategy {name!r}; "
                           f"registered: {sorted(_strategies)}")
        _strategies[name] = KernelStrategy(name, choices, env_var, auto)
    return _strategies[name]


def get_strategy(name: str) -> KernelStrategy:
    if name not in _strategies:
        raise KeyError(f"unknown kernel strategy {name!r}; "
                       f"registered: {sorted(_strategies)}")
    return _strategies[name]


def list_strategies() -> list[str]:
    return sorted(_strategies)


def set_default_strategy(name: str, choice: str | None) -> None:
    """Process-wide strategy override (``None`` clears it)."""
    strat = get_strategy(name)
    if choice is None:
        _default_strategies.pop(name, None)
        return
    strat._validate(choice, "set_default_strategy")
    _default_strategies[name] = choice


@contextmanager
def use_strategy(name: str, choice: str | None):
    """Scoped :func:`set_default_strategy`."""
    prev = _default_strategies.get(name)
    set_default_strategy(name, choice)
    try:
        yield
    finally:
        set_default_strategy(name, prev)


# ------------------------------------------------------ dispatch records --

def dispatch_log() -> tuple[tuple[str, str], ...]:
    """The most recent ``(name, choice)`` dispatches and strategy
    resolutions, oldest first — at most :data:`LOG_MAXLEN` of them."""
    return tuple(_log)


def dispatch_counts() -> dict[tuple[str, str], int]:
    """Every ``(name, choice)`` since the last reset, counted in full
    (not bounded by the log's length)."""
    return dict(_counts)


def last_dispatch(op_name: str) -> str | None:
    """The impl most recently dispatched for ``op_name`` (None if never)."""
    for name, impl in reversed(_log):
        if name == op_name:
            return impl
    return None


def reset_dispatch_log() -> None:
    _log.clear()
    _counts.clear()

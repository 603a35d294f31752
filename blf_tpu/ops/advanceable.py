"""The ``Advanceable`` protocol: incremental computation as pure steps.

The reference's ``Advanceable<T>`` interface (`/root/reference/src/System/
include/BipedalLocomotion/System/Advanceable.h:24-46`) is a mutable
``get()/isValid()/advance()`` triple: call ``advance()`` to move hidden
member state one tick, ``get()`` to read the output, ``isValid()`` to learn
whether it worked. The accelerator-native realization (SURVEY.md §7 "streaming
iterator protocol") is the **step convention**::

    step(carry, *inputs) -> (carry', output)

- ``carry`` is the explicit state the reference hid in members — a pytree,
  so it batches under ``vmap`` and shards under ``shard_map``;
- ``output`` is ``get()``'s value for this tick;
- validity is data, not a bool method: outputs/states carry status arrays
  (:mod:`blf_tpu.utils.status`) because a batched lane cannot throw.

Everything stateful in the framework already follows it —
``rls_step(params, state, A, y) -> RLSState`` (estimators),
``make_fleet_step(...)(state, …) -> (FleetState, TickResult)`` (sweep),
``make_stack_step(...)(stack, …) -> (StackState, StackTrace)`` (control
stack), ``momentum_observer_step`` — and this module makes the convention
*checkable and composable* instead of folklore:

- :class:`Advanceable` — a ``typing.Protocol`` for static/duck typing;
- :func:`advance_scan` — drive any conforming step over a tick sequence
  with ``lax.scan`` (the ``FixedStepIntegrator::integrate`` loop shape,
  ``FixedStepIntegrator.tpp:48-61``, as one fused program);
- :func:`check_advanceable` — the contract test helper: one traced call,
  shape/dtype-stable carry (a step must be scannable: carry' must have
  exactly carry's treedef/shapes/dtypes).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Protocol, Tuple, runtime_checkable

import jax

__all__ = ["Advanceable", "advance_scan", "check_advanceable"]


@runtime_checkable
class Advanceable(Protocol):
    """Anything callable as ``step(carry, *inputs) -> (carry', output)``."""

    def __call__(self, carry: Any, *inputs: Any) -> Tuple[Any, Any]: ...


def advance_scan(
    step: Advanceable,
    carry: Any,
    xs: Any = None,
    *,
    length: Optional[int] = None,
    unroll: int = 1,
):
    """Run ``step`` over a tick sequence; returns ``(final_carry, outputs)``.

    ``xs`` is a pytree of per-tick inputs with a leading time axis (or
    ``None`` with ``length`` for autonomous systems — the step is then
    called as ``step(carry)``). The per-tick slice is passed as ONE
    argument, whatever its pytree structure; steps taking several arrays
    take them as a tuple. This is the reference's ``integrate(t0, tf)``
    loop as a single ``lax.scan`` — one compiled program regardless of
    tick count.
    """
    def body(c, x):
        if x is None:
            return step(c)
        return step(c, x)

    return jax.lax.scan(body, carry, xs, length=length, unroll=unroll)


def check_advanceable(step: Advanceable, carry: Any, *inputs: Any) -> None:
    """Assert ``step`` honours the contract; raises ``TypeError`` otherwise.

    Checks (under ``eval_shape`` — no FLOPs, works for any backend):
    1. the step returns a 2-tuple ``(carry', output)``;
    2. ``carry'`` has exactly ``carry``'s treedef, shapes, and dtypes —
       the property ``lax.scan`` needs, and the reason the reference's
       resize-on-advance patterns cannot appear here.
    """
    out = jax.eval_shape(step, carry, *inputs)
    if not (isinstance(out, tuple) and len(out) == 2):
        raise TypeError(
            f"step must return (carry, output); got {type(out).__name__}"
        )
    carry_shape = jax.eval_shape(lambda c: c, carry)
    got, want = out[0], carry_shape
    got_tree = jax.tree_util.tree_structure(got)
    want_tree = jax.tree_util.tree_structure(want)
    if got_tree != want_tree:
        raise TypeError(
            f"carry treedef changed across step: {want_tree} -> {got_tree}"
        )
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise TypeError(
                f"carry leaf changed across step: {w.shape}/{w.dtype} -> "
                f"{g.shape}/{g.dtype} (scan requires a stable carry)"
            )

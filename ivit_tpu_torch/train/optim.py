"""The optimizer of the QAT trainer, op for op as optax 0.2.6 computes it
(counterpart of what ``ivit_tpu/train/trainer.py::build_optimizer`` builds
from optax).

A transformation is an ``init(params) -> state`` / ``update(grads, state,
params) -> (updates, state)`` pair over trees: nested dicts of tensors in
the flax layout (``models/convert.py``).  The states are laid out as
flax's ``to_state_dict`` lays out optax's: a chain's as ``{"0": ..., "1":
...}``, a named tuple's by field name in field order
(``ScaleByAdamState`` as ``count`` / ``mu`` / ``nu``, ``MultiStepsState``,
``MaskedState.inner_state``), an empty state as ``{}``; so a checkpoint
written by the JAX trainer loads into it (``train/checkpoint.py``).

Each element-wise step is its own rounded f32 operation in optax's order:
``(1 - b1) * g + b1 * mu``, not ``torch.optim.AdamW``'s decay of the
weight before the Adam step (optax adds ``wd * p`` to the update).  The
scalars that optax computes from a step count -- the schedule's value, the
bias corrections ``1 - b ** count`` -- are computed on the host from the
count (one device read a transformation that holds one), so that every
device gets the same f32 scalar, and every root is the correctly rounded
``ops/quant.py::sqrt_rn``, XLA's; ``b ** count`` is rounded from float64,
as XLA:CPU computes the jitted ``tree_bias_correction``, and the cosine
is rounded from the float64 ``cos`` (XLA:CPU's f32 ``cos`` is not
correctly rounded: the schedule is within an ulp of optax's,
``tests/test_torch_port_train.py``).  The global norm's per-leaf sums
run in torch's reduction order, not XLA's.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..ops.quant import sqrt_rn, true_divide
from ..parallel import collectives as coll
from ..parallel.mesh import is_model_sharded

f32 = np.float32
INT32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# Trees: nested dicts with tensor (or array) leaves
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same paths of ``rest``),
    keeping ``tree``'s key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree, path=()):
    """``(path, leaf)`` pairs in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    else:
        yield path, tree


def _count(state_count) -> int:
    return int(state_count.item())


def safe_increment(count):
    """``numerics.safe_increment`` of an int32 count tensor: +1, held at the
    int32 maximum."""
    return torch.where(count < INT32_MAX, count + 1, count)


def global_norm(tree):
    """``optax.global_norm``: ``sqrt`` of the leaves' sums of squares, added
    in leaf order starting from the first (Python's ``sum``), in f32.

    Under an active tensor-parallel mesh the leaves cut over the model axis
    (``parallel.mesh.is_model_sharded``) hold a shard each: their squares
    are summed over the model axis, and the replicated leaves are counted
    once."""
    mesh = coll.active()
    if mesh is None or mesh.tp == 1:
        total = None
        for x in tree_leaves(tree):
            s = torch.sum(x * x)
            total = s if total is None else total + s
        return sqrt_rn(total)
    parts = {True: None, False: None}
    for path, x in tree_paths(tree):
        s = torch.sum(x * x)
        cut = is_model_sharded(path)
        parts[cut] = s if parts[cut] is None else parts[cut] + s
    total = coll.all_reduce_sum(parts[True], "model")
    if parts[False] is not None:
        total = parts[False] + total
    return sqrt_rn(total)


# ---------------------------------------------------------------------------
# Schedules: host functions of an int count, returning np.float32
# ---------------------------------------------------------------------------

def linear_schedule(init_value, end_value, transition_steps,
                    transition_begin=0) -> Callable[[int], np.float32]:
    """``optax.linear_schedule`` (``polynomial_schedule`` of power 1):
    ``(init - end) * (1 - clip(count - begin, 0, T) / T) + end``."""
    if transition_steps <= 0:
        return lambda count: f32(init_value)
    transition_begin = max(transition_begin, 0)
    scale = f32(init_value - end_value)

    def schedule(count):
        c = min(max(int(count) - transition_begin, 0), transition_steps)
        frac = f32(f32(1.0) - f32(f32(c) / f32(transition_steps)))
        return f32(f32(scale * frac) + f32(end_value))

    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """``optax.cosine_decay_schedule`` (exponent 1): ``init * ((1 - alpha) *
    0.5 * (1 + cos(pi * min(count, T) / T)) + alpha)``."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, "
                         f"got decay_steps={decay_steps}.")
    t_steps = f32(float(decay_steps))

    def schedule(count):
        c = f32(min(f32(int(count)), t_steps))
        t = f32(f32(f32(math.pi) * c) / t_steps)
        # XLA:CPU's f32 cos is not correctly rounded, this one is: the value
        # may differ from optax's by an ulp (tests/test_torch_port_train.py)
        cosine = f32(f32(0.5) * f32(f32(1.0) + f32(math.cos(float(t)))))
        decayed = f32(f32(f32(1 - alpha) * cosine) + f32(alpha))
        return f32(f32(init_value) * decayed)

    return schedule


def join_schedules(schedules, boundaries):
    """``optax.join_schedules``: each schedule from its boundary on, counted
    from it."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if not count < boundary:
                out = sched(count - boundary)
        return f32(out)

    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps,
                                 end_value=0.0):
    """``optax.warmup_cosine_decay_schedule``: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine decay
    to ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
        [warmup_steps])


# ---------------------------------------------------------------------------
# Gradient transformations
# ---------------------------------------------------------------------------

class GradientTransformation:
    """An ``(init, update)`` pair, as optax's."""

    def __init__(self, init, update):
        self.init, self.update = init, update


def _empty_init(params):
    return {}


def _int32_zero(params):
    leaf = next(iter(tree_leaves(params)), None)
    device = leaf.device if isinstance(leaf, torch.Tensor) else None
    return torch.zeros((), dtype=torch.int32, device=device)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """``optax.clip_by_global_norm``: each leaf ``(t / norm) * max_norm``
    where the global norm is not below ``max_norm``."""
    m = float(f32(max_norm))

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < m
        return tree_map(lambda t: torch.where(trigger, t, (t / g_norm) * m),
                        updates), state

    return GradientTransformation(_empty_init, update)


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in f32, ``decay ** count`` rounded from float64
    as the jitted ``tree_bias_correction`` computes it on XLA:CPU."""
    power = f32(float(f32(decay)) ** count)
    return float(f32(f32(1.0) - power))


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    """``optax.scale_by_adam``: the moments ``(1 - b) * g**k + b * m``, the
    bias-corrected ``mu_hat / (sqrt(nu_hat) + eps)``; state ``count`` (int32),
    ``mu``, ``nu``."""
    c1, c2 = float(f32(1 - b1)), float(f32(1 - b2))
    d1, d2, e = float(f32(b1)), float(f32(b2)), float(f32(eps))

    def init(params):
        return {"count": _int32_zero(params),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        mu = tree_map(lambda g, t: g * c1 + t * d1, updates, state["mu"])
        nu = tree_map(lambda g, t: (g * g) * c2 + t * d2, updates, state["nu"])
        count = safe_increment(state["count"])
        n = _count(count)
        bc1, bc2 = bias_correction(b1, n), bias_correction(b2, n)
        out = tree_map(lambda m, v: (true_divide(m, bc1)
                                     / (sqrt_rn(true_divide(v, bc2)) + e)), mu, nu)
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float, mask) -> GradientTransformation:
    """``optax.add_decayed_weights`` with a ``mask`` (a function of the
    params giving a tree of bools), through ``optax.masked``: ``g + wd * p``
    where the mask is True; state ``{"inner_state": {}}``."""
    wd = float(f32(weight_decay))

    def update(updates, state, params):
        return tree_map(lambda g, p, k: g + p * wd if k else g,
                        updates, params, mask(params)), state

    return GradientTransformation(lambda params: {"inner_state": {}}, update)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """``optax.scale_by_learning_rate`` of a schedule: ``-lr(count) * g``;
    state ``count`` (``ScaleByScheduleState``)."""

    def init(params):
        return {"count": _int32_zero(params)}

    def update(updates, state, params=None):
        step = float(f32(-1 * learning_rate(_count(state["count"]))))
        return (tree_map(lambda g: g * step, updates),
                {"count": safe_increment(state["count"])})

    return GradientTransformation(init, update)


def chain(*txs) -> GradientTransformation:
    """``optax.chain``: state ``{"0": ..., "1": ..., ...}``."""
    def init(params):
        return {str(i): tx.init(params) for i, tx in enumerate(txs)}

    def update(updates, state, params=None):
        new = {}
        for i, tx in enumerate(txs):
            updates, new[str(i)] = tx.update(updates, state[str(i)], params)
        return updates, new

    return GradientTransformation(init, update)


def adamw(learning_rate, weight_decay, mask, b1=0.9, b2=0.999,
          eps=1e-8) -> GradientTransformation:
    """``optax.adamw`` with a schedule and a decay mask: ``scale_by_adam`` ->
    ``add_decayed_weights(mask)`` -> ``scale_by_learning_rate``."""
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(learning_rate))


class MultiSteps:
    """``optax.MultiSteps`` (``use_grad_mean``): the running mean of the last
    ``every_k_schedule`` gradients, ``acc + (g - acc) / (n + 1)``; the inner
    update is computed every mini-step and applied (its state kept, the
    accumulator zeroed) on the k-th, as optax selects it, the other updates
    ``0 * u``.  State: ``mini_step``, ``gradient_step``,
    ``inner_opt_state``, ``acc_grads``, ``skip_state`` (``{}``)."""

    def __init__(self, opt: GradientTransformation, every_k_schedule: int):
        if not isinstance(every_k_schedule, int):
            raise ValueError("MultiSteps takes a constant every_k_schedule here")
        self.inner_opt, self.k = opt, every_k_schedule

    def init(self, params):
        zero = _int32_zero(params)
        return {"mini_step": zero, "gradient_step": zero.clone(),
                "inner_opt_state": self.inner_opt.init(params),
                "acc_grads": tree_map(torch.zeros_like, params), "skip_state": {}}

    def update(self, updates, state, params=None):
        n = _count(state["mini_step"])
        acc = tree_map(lambda g, a: a + true_divide(g - a, float(n + 1)),
                       updates, state["acc_grads"])
        final, inner = self.inner_opt.update(acc, state["inner_opt_state"], params)
        emit = n == self.k - 1
        keep, scale = (0.0, 1.0) if emit else (1.0, 0.0)
        mini = safe_increment(state["mini_step"]) % self.k
        step = safe_increment(state["gradient_step"]) if emit \
            else state["gradient_step"]
        new = {"mini_step": mini, "gradient_step": step,
               "inner_opt_state": inner if emit else state["inner_opt_state"],
               "acc_grads": tree_map(lambda a: a * keep, acc),
               "skip_state": state["skip_state"]}
        return tree_map(lambda u: u * scale, final), new

    def has_updated(self, state) -> bool:
        return _count(state["mini_step"]) == 0 and _count(state["gradient_step"]) > 0


def apply_updates(params, updates):
    """``optax.apply_updates``, in place: ``p += u`` on each leaf (call
    under ``torch.no_grad()``); returns ``params``."""
    tree_map(lambda p, u: p.add_(u), params, updates)
    return params

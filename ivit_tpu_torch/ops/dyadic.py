"""Dyadic (fixed-point) requantization scale decomposition (counterpart of
``ivit_tpu/ops/dyadic.py``, numpy only, kept as the port's own copy).

The load-bearing deployment trick of the I-ViT scheme: every requantization
between two quantized tensors with scales ``s_in`` and ``s_out`` is an integer
multiply by a 31-bit mantissa followed by a power-of-two right shift:

    out_int = round(in_int * m / 2**e)        with  m/2**e  ~=  s_in / s_out

The reference computes the ``(m, e)`` pair *per forward pass on the host*
(the reference I-ViT's ``models/quantization_utils/quant_utils.py:151-175``,
``batch_frexp`` — np.frexp + per-element ``Decimal`` ROUND_HALF_UP) which is a
known hot-loop sink.  Here the decomposition is a pure vectorized numpy
function meant to run **once at model-freeze time**; the engine then carries
the precomputed pairs as static metadata.

Semantics are bit-identical to the reference: for a float64 multiplier ``M``,
``np.frexp`` gives ``M = m_f * 2**E`` with ``m_f in [0.5, 1)``; the mantissa is
``round_half_up(m_f * 2**31)`` and the shift is ``e = 31 - E``.  (Both the
frexp mantissa and ``m_f * 2**31`` are exactly representable in float64, so
``floor(x + 0.5)`` reproduces ``Decimal(...).quantize(ROUND_HALF_UP)``
exactly.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_BIT = 31


def batch_frexp(scale_ratio, max_bit: int = MAX_BIT):
    """Decompose positive float multipliers into (mantissa, exponent) pairs.

    Parameters
    ----------
    scale_ratio : array-like of float
        The multipliers ``s_in / s_out`` (any shape).
    max_bit : int
        Mantissa precision (reference uses 31).

    Returns
    -------
    (m, e) : tuple of int64 / int64 numpy arrays, same shape as input.
        ``m in [2**(max_bit-1), 2**max_bit]``, and
        ``m * 2.0**-e`` approximates ``scale_ratio`` to ``max_bit`` bits.
    """
    ratio = np.asarray(scale_ratio, dtype=np.float64)
    m_f, exp = np.frexp(ratio)
    # round-half-up of m_f * 2**max_bit; exact in float64 (see module docstring)
    m = np.floor(m_f * (2.0**max_bit) + 0.5).astype(np.int64)
    e = (max_bit - exp).astype(np.int64)
    return m, e


def dyadic_to_multiplier(m, e):
    """Reconstruct the effective float64 multiplier ``m * 2**-e``."""
    m = np.asarray(m, dtype=np.float64)
    e = np.asarray(e, dtype=np.float64)
    return m * np.exp2(-e)


@dataclasses.dataclass(frozen=True)
class Dyadic:
    """A frozen dyadic multiplier ``m / 2**e`` (arrays broadcast per-channel).

    ``apply_exact`` is the hardware-true integer evaluation (int64 host/numpy
    semantics, used in tests and the bit-exact engine mode); the engines fold
    ``multiplier`` into a float32 epilogue instead (see
    ``ivit_tpu_torch.engine``).
    """

    m: np.ndarray  # int64 mantissas
    e: np.ndarray  # int64 exponents

    @classmethod
    def from_ratio(cls, scale_ratio) -> "Dyadic":
        m, e = batch_frexp(scale_ratio)
        return cls(m=m, e=e)

    @property
    def multiplier(self) -> np.ndarray:
        return dyadic_to_multiplier(self.m, self.e)

    def apply_exact(self, z: np.ndarray) -> np.ndarray:
        """round(z * m / 2**e) on int64 numpy arrays, round-half-to-even.

        Matches the reference ``fixedpoint_mul`` float64 evaluation
        (``quant_utils.py:229-230``: ``torch.round(z*m / 2.0**e)``) for all
        products representable in float64, which covers every in-envelope
        tensor of the scheme (|z| < 2**31, m < 2**31 -> product < 2**62; the
        reference itself loses bits beyond 2**53, and we reproduce its float64
        rounding rather than raw-integer rounding).
        """
        z = np.asarray(z, dtype=np.float64)
        return np.round(z * self.m.astype(np.float64) / np.exp2(self.e.astype(np.float64)))

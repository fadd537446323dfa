"""The table form of Shiftmax that the standalone CUDA kernel runs, bit-exact
against the plain version and against JAX.

``shiftmax`` on the card (``csrc/nonlinear.cu`` ``shiftmax_kernel``) never
runs the exp chain per element.  The scores are int8 and a row's max is one
of them, so an element's exp is ``int_exp_shift(-d)`` with d = max - x in
[0, 255].  Each block first builds the 256-entry table of those exps.  A
row is then the max, a lookup, the two int32 limbs ``p >> 8`` and ``p &
255`` of p = min(exp, 2**31) as an integer (summed as the high limbs and
the whole words, the low limbs' sum their difference), one ``rdiv`` for the
factor, and per output ``floor(min(exp * (factor * 2**-k), pmax *
2**-k))`` (a round-down add of 2**23, or in a row whose sum wrapped the
conversion to int32 rounding down) stored in the container; the padding
columns are written 0.  :func:`kernel_tables` and
:func:`table_form` mirror those steps, and the tests hold them bitwise
against three things:

* the entries against JAX's ``_int_exp_shift``
  (``ivit_tpu/ops/pallas/nonlinear.py``) at every d, at scales whose x0
  runs from -1 to below -2**13, with both quotient forms;
* the row form against JAX's ``shiftmax_int`` (``ivit_tpu/ops/ivit.py``)
  and the port's plain ``shiftmax_ref``, over random, one-hot and flat
  rows, N 1, 17, 197 and 700, n_valid N, 1 and N - 1, and 2- to 16-bit
  probabilities (the saturation at 8 and 16 bits included), and flat rows
  whose exp sum wraps past 2**31 (negative probabilities);
* the row form against ``shiftmax_p`` in interpret mode on one small shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.ops import ivit as jiv
from ivit_tpu.ops.pallas import nonlinear as jnl
from ivit_tpu_torch.ops import ivit as iv
from ivit_tpu_torch.ops.kernels import block as kb
from ivit_tpu_torch.ops.kernels import nonlinear as knl
from ivit_tpu_torch.ops.quant import rdiv

# x0 = floor(-1 / s): -1, -2, -17, -20, -219, -10,000, -33,334
SCALES = [2.0, 0.5, 0.061, 0.0521371, 0.0045778966, 1e-4, 3e-5]
SHIFT_PRODUCT_MAX = 2147483520.0    # the largest f32 below 2**31


def kernel_table(s_attn, fast_q):
    """The kernel's prologue: entry d holds int_exp_shift(-d)."""
    e, _ = iv.int_exp_shift(torch.arange(0.0, -256.0, -1.0), s_attn, 15, fast_q)
    return e


def table_form(scores, s_attn, bits, n_valid, fast_q):
    """Shiftmax of int8-valued rows [..., N] as the kernel computes it."""
    e_tab = kernel_table(s_attn, fast_q)
    x = torch.as_tensor(scores).to(torch.int64)
    valid = torch.arange(x.shape[-1]) < n_valid
    vmax = torch.where(valid, x, -128).amax(-1, keepdim=True)
    e = e_tab[torch.where(valid, vmax - x, 0)]
    p = torch.where(valid, torch.clamp(e, max=2.0**31).to(torch.int64), 0)
    # the high limbs' sum and the words' sum, each wrapping at 2**32 as the
    # lanes' uint32 adds and the warp sum do; the low limbs' sum is the
    # difference
    hi = (p >> 8).sum(-1, keepdim=True) & 0xFFFFFFFF
    lo = (p.sum(-1, keepdim=True) - (hi << 8)) & 0xFFFFFFFF
    assert torch.equal(lo, (p & 255).sum(-1, keepdim=True))
    total = hi.to(torch.int32).float() * 256.0 + lo.to(torch.int32).float()
    factor = torch.floor(rdiv(iv.INT32_MAX, torch.clamp(total, max=iv.INT32_MAX)))
    out_scale = 2.0 ** (bits - 32)
    pmax = SHIFT_PRODUCT_MAX if bits in (8, 16) else 2.0**31
    v = torch.clamp(e * (factor * out_scale), max=pmax * out_scale)
    # the kernel's floor: in a row whose factor is >= 0, v + 2**23 rounded
    # down, exact for 0 <= v < 2**23; in a row whose sum wrapped, the f32 ->
    # int32 conversion rounding down, exact for a floor inside int32; the
    # store truncates to the container
    q = torch.floor(v)
    by_add = (factor >= 0).expand_as(v)
    assert bool(((v >= 0) & (v < 2.0**23))[by_add].all())
    assert bool(((q >= -2.0**31) & (q < 2.0**31))[~by_add].all())
    return torch.where(valid, q.to(torch.int32), 0).to(kb.container(bits))


def _rows(n, seed):
    """Random rows, one-hot rows (one 127 among -128s) and a flat row."""
    rng = np.random.default_rng(seed)
    hot = np.full((2, n), -128)
    hot[0, 0] = hot[1, n - 1] = 127
    return np.concatenate([rng.integers(-128, 128, (6, n)), hot,
                           np.full((1, n), 5)]).astype(np.int8)


@pytest.mark.parametrize("fast_q", [False, True])
@pytest.mark.parametrize("s_attn", SCALES)
def test_table_entries_match_jax_int_exp_shift(s_attn, fast_q):
    d = np.arange(256, dtype=np.float32)
    want = np.asarray(jnl._int_exp_shift(jnp.asarray(-d), jnp.float32(s_attn), 15,
                                         fast_q))
    e = kernel_table(s_attn, fast_q)
    np.testing.assert_array_equal(e.numpy(), want)
    # p = min(e, 2**31) as an integer splits as limb_add splits the clamped
    # exp
    p = torch.clamp(e, max=2.0**31).to(torch.int64)
    xc = np.minimum(want.astype(np.float64), 2.0**31)
    np.testing.assert_array_equal((p >> 8).numpy(), np.floor(xc / 256))
    np.testing.assert_array_equal((p & 255).numpy(), xc % 256)


@pytest.mark.parametrize("bits", [2, 7, 8, 9, 16])
@pytest.mark.parametrize("n", [1, 17, 197, 700])
def test_table_form_matches_jax_shiftmax_int(n, bits):
    scores = _rows(n, seed=n)
    lo, hi = (-128, 127) if bits <= 8 else (-32768, 32767)
    # JAX takes every scale at once, broadcast against the rows
    scales = jnp.asarray(SCALES, jnp.float32)[:, None, None]
    for n_valid in sorted({n, 1, max(n - 1, 1)}):
        for fast_q in (False, True):
            probs, _ = jiv.shiftmax_int(jnp.asarray(scores, jnp.float32), scales,
                                        bits, n_valid=n_valid, fast_q=fast_q)
            want = np.clip(np.asarray(probs), lo, hi)
            for i, s_attn in enumerate(SCALES):
                got = table_form(scores, s_attn, bits, n_valid, fast_q)
                np.testing.assert_array_equal(got.numpy(), want[i],
                                              err_msg=f"{s_attn} {n_valid} {fast_q}")
                ref = knl.shiftmax_ref(torch.from_numpy(scores), s_attn, bits,
                                       n_valid=n_valid, fast_q=fast_q)
                assert torch.equal(got, ref), (s_attn, n_valid, fast_q)


@pytest.mark.parametrize("fast_q", [False, True])
@pytest.mark.parametrize("bits", [8, 16])
def test_wrapped_row_sum_matches_jax(bits, fast_q):
    """Flat rows of 1,024 whose exps sum past 2**31 (x0 -20,000 and -25,000):
    the high limbs' int32 sum wraps in JAX too, the factor turns negative,
    and so do the probabilities.  (``_rows``' flat row of 700 at s 3e-5
    wraps as well, in the test above.)"""
    scores = np.full((3, 1024), 5, np.int8)
    wrapping = [5e-5, 4e-5]
    probs, _ = jiv.shiftmax_int(jnp.asarray(scores, jnp.float32),
                                jnp.asarray(wrapping, jnp.float32)[:, None, None],
                                bits, fast_q=fast_q)
    for i, s_attn in enumerate(wrapping):
        got = table_form(scores, s_attn, bits, 1024, fast_q)
        assert (got < 0).all()
        np.testing.assert_array_equal(got.numpy(), np.asarray(probs)[i])
        assert torch.equal(got, knl.shiftmax_ref(torch.from_numpy(scores), s_attn,
                                                 bits, fast_q=fast_q))


def test_one_column_probability_saturates():
    """A one-column row whose exp is a power of two (x0 = -1, -2) reaches
    2**(bits - 1) before the container clamps it: 127 and 32767."""
    scores = _rows(1, seed=0)
    for s_attn in (2.0, 0.5):
        assert (table_form(scores, s_attn, 8, 1, True) == 127).all()
        assert (table_form(scores, s_attn, 16, 1, False) == 32767).all()
        assert (table_form(scores, s_attn, 9, 1, True) == 256).all()


@pytest.mark.parametrize("fast_q", [False, True])
def test_table_form_matches_pallas_shiftmax(fast_q):
    """The Pallas kernel itself, in interpret mode, on one small shape."""
    scores = _rows(197, seed=1).reshape(3, 3, 197)
    s_attn = 0.0521371
    for bits, n_valid in ((8, 180), (16, None)):
        want = jnl.shiftmax_p(jnp.asarray(scores), jnp.float32(s_attn), bits,
                              n_valid=n_valid, interpret=True, fast_q=fast_q)
        got = table_form(scores, s_attn, bits, n_valid or 197, fast_q)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

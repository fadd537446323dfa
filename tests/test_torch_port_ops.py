"""The port's integer cores bit-exact against the JAX package's.

Every hot input of the engine's nonlinearities is an int8 integer, so the
exp, softmax and GELU cores are checked over the whole int8 domain (and
the whole int8-difference domain for the exp), at calibrated scales and at
scales where the freeze gates fail.  The sums and LayerNorm take random
int16/int32 ranges, including variances past 2**24.  Exact equality
throughout: the ibert family has no float transcendental whose rounding
could differ, and sqrt is correctly rounded in both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.ops import ibert as jib
from ivit_tpu.ops import quant as jq
from ivit_tpu_torch.ops import ibert as tib
from ivit_tpu_torch.ops import quant as tq

# calibrated DeiT-S sizes, larger, and small enough that the freeze gates
# fail: s < ~5e-4 fails fast_poly, s < ~1.3e-6 fails fast_exp
SCALES = [0.005533343, 0.013059441, 0.0521371, 0.0004, 1e-6]
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


INT8 = np.arange(-128, 128, dtype=np.float32)
DIFF = np.arange(-255, 1, dtype=np.float32)         # x - rowmax of int8 scores


@pytest.mark.parametrize("s", SCALES)
def test_int_exp_whole_difference_domain(s):
    for fast_q, fast_poly in FLAGS:
        got, _ = tib.int_exp(_t(DIFF), _t(s), fast_q=fast_q, fast_poly=fast_poly)
        want, _ = jib.int_exp(jnp.asarray(DIFF), jnp.float32(s), fast_q=fast_q,
                              fast_poly=fast_poly)
        _eq(got, want)


@pytest.mark.parametrize("s", SCALES)
def test_softmax_exp_whole_int8_domain(s):
    rng = np.random.default_rng(0)
    rows = np.stack([rng.permutation(INT8) for _ in range(4)])   # [4, 256]
    for n_valid in (None, 200):
        for fast_q, fast_poly in FLAGS:
            got, _ = tib.ibert_softmax_exp_int(_t(rows), _t(s), n_valid=n_valid,
                                               fast_q=fast_q, fast_poly=fast_poly)
            want, _ = jib.ibert_softmax_exp_int(jnp.asarray(rows), jnp.float32(s),
                                                n_valid=n_valid, fast_q=fast_q,
                                                fast_poly=fast_poly)
            _eq(got, want)


@pytest.mark.parametrize("s", SCALES)
def test_gelu_whole_int8_domain(s):
    for fast_poly in (False, True):
        got, got_s = tib.ibert_gelu_int(_t(INT8), _t(s), fast_poly=fast_poly)
        want, want_s = jib.ibert_gelu_int(jnp.asarray(INT8), jnp.float32(s),
                                          fast_poly=fast_poly)
        _eq(got, want)
        _eq(got_s, want_s)


@pytest.mark.parametrize("lim", [2**7, 2**15, 2**24, 2**30])
def test_exact_int_sum(lim):
    x = np.random.default_rng(lim).integers(-lim, lim, (16, 384)).astype(np.float32)
    _eq(tq.exact_int_sum(_t(x)), jq.exact_int_sum(jnp.asarray(x)))


@pytest.mark.parametrize("lim", [2**7, 2**12, 2**15, 2**16])
def test_exact_sq_sum(lim):
    y = np.random.default_rng(lim).integers(-lim, lim, (16, 384)).astype(np.float32)
    got = tq.exact_sq_sum(_t(y))
    _eq(got, jq.exact_sq_sum(jnp.asarray(y)))
    if lim >= 2**15:
        assert float(got.max()) > 2**24             # past the f32-exact sums


@pytest.mark.parametrize("lim,shift", [(2**7, 0.0), (2**15, 0.0), (2**15, 3.0)])
def test_layernorm(lim, shift):
    rng = np.random.default_rng(lim)
    x = rng.integers(-lim, lim, (32, 384)).astype(np.float32)
    x[0] = 5.0                                       # zero variance: NaN row
    c = x.shape[-1]
    for use_int_sqrt in (False, True):
        got = tib.ibert_layernorm_int(_t(x), _t(shift), use_int_sqrt=use_int_sqrt)
        want, _, _ = jib.ibert_layernorm_int(
            jnp.asarray(x), jnp.ones(c), jnp.zeros(c), jnp.float32(shift),
            overflow_handling=False, use_int_sqrt=use_int_sqrt)
        _eq(got, want)


def test_int_bitlength_sqrt_near_powers_of_two():
    ks = np.arange(1, 40)
    n = np.unique(np.concatenate([2.0**ks + d for d in (-3, -2, -1, 0, 1, 2)]))
    n = np.concatenate([n, np.random.default_rng(0).integers(0, 2**40, 2000)])
    n = np.asarray(n, np.float32)
    _eq(tib.int_bitlength_sqrt(_t(n)), jib.int_bitlength_sqrt(jnp.asarray(n)))


def test_int_sqrt_and_floor_sqrt_differ():
    """The ibert LN's two sqrt forms disagree on some variances (3, 15, 63,
    80, 99 are the first), so the fused kernels, which take floor(sqrt) as
    the Pallas kernel does, refuse ``use_int_sqrt``."""
    n = np.array([3, 15, 63, 80, 99], np.float32)
    want = np.asarray(jib.int_bitlength_sqrt(jnp.asarray(n)))
    _eq(tib.int_bitlength_sqrt(_t(n)), want)
    assert (want != np.floor(np.sqrt(n))).all()


def test_rdiv_floor_div_exact_fma_random():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(20000) * 10.0 ** rng.integers(-6, 9, 20000)).astype(np.float32)
    b = (rng.standard_normal(20000) * 10.0 ** rng.integers(-6, 9, 20000)).astype(np.float32)
    c = (rng.standard_normal(20000) * 10.0 ** rng.integers(-6, 9, 20000)).astype(np.float32)
    _eq(tq.rdiv(_t(a), _t(b)), jq.rdiv(jnp.asarray(a), jnp.asarray(b)))
    _eq(tq.exact_fma(_t(a), _t(b), _t(c)),
        jq.exact_fma(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    # integer operands of the exp chains: x in [30 x0, 0], x0 < 0
    x0 = -rng.integers(1, 2**14, 20000).astype(np.float32)
    x = np.floor(rng.uniform(0, 1, 20000) * 30 * x0).astype(np.float32)
    _eq(tq.floor_div_int(_t(x), _t(x0)), jq.floor_div_int(jnp.asarray(x),
                                                         jnp.asarray(x0)))
    _eq(torch.floor(tq.rdiv(_t(x), _t(x0))),
        jnp.floor(jq.rdiv(jnp.asarray(x), jnp.asarray(x0))))


def test_pow2_and_gate():
    k = np.arange(-130, 131, dtype=np.float32)
    _eq(tq.pow2(_t(k)), jq.pow2(jnp.asarray(k)))
    for x0 in (-1.0, -138.0, -2.0**19, -2.0**19 - 1, 0.0, float("-inf")):
        for n in (15, 23, 30):
            assert tq.exp_fastdiv_ok(x0, n) == jq.exp_fastdiv_ok(x0, n)

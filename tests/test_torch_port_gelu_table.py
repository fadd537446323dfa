"""The table form of ShiftGELU + requant that the CUDA kernels run, bit-exact
against the plain version and against JAX.

``mlp_block`` (ivit GELU) and ``shift_gelu_requant`` on the card first
compute, once a call, the output ``requant(shift_gelu(x), m_gelu)`` of
every (row max xmax, value x <= xmax) pair of the int8 domain
(``csrc/ivit.cuh`` ``shift_gelu_table_kernel``): an element's output
depends only on its value and its row's max, and its exp only on d = xmax
- x.  Then each row looks its elements up in its max's 256 entries.
:func:`launch_table` mirrors that construction step for step (the 256
exps int_exp_shift(-d), each row max's ``exp_max``, then for each entry
the exp sum, the 2**31 reciprocal, the sigmoid, x * sigmoid and the
requant), and the tests hold the lookup bitwise, over every (x, xmax)
pair, against ``ivit_tpu_torch.ops.ivit.shift_gelu_int`` followed by the
requant, at the GELU scales of the tests and of ``engine/synthetic.py``
plus 1e-3 and 1.0, fast quotient both ways; and against JAX
``ivit_tpu/ops/pallas/block.py::_shift_gelu`` directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.ops.pallas import block as jblk
from ivit_tpu_torch.engine.synthetic import CALIBRATED_S_GELU, CALIBRATED_S_GELU_IVIT
from ivit_tpu_torch.ops import ivit as iv
from ivit_tpu_torch.ops.quant import f32, rdiv

SCALES = [0.0417093, *CALIBRATED_S_GELU, *CALIBRATED_S_GELU_IVIT, 1e-3, 1.0]
M_GELU = [0.031727, 0.5]


def _requant(y, m, bits=8):
    lim = 2.0 ** (bits - 1)
    return torch.clamp(torch.round(y * f32(m)), -lim, lim - 1)


def launch_table(s_gelu, m_gelu, output_bit=8, n=23, fast_q=False):
    """[256, 256]: entry [xmax + 128, x + 128] is the output of value x in a
    row whose max is xmax (entries past xmax are never looked up)."""
    s_sig = f32(s_gelu) * 1.702
    exps, _ = iv.int_exp_shift(torch.arange(0.0, -256.0, -1.0), s_sig, n, fast_q)
    xmax = torch.arange(-128.0, 128.0)[:, None]
    x = torch.arange(-128.0, 128.0)[None, :]
    exp_int = exps[torch.clamp(xmax - x, 0, 255).long()]
    exp_max, _ = iv.int_exp_shift(-xmax, s_sig, n, fast_q)
    exp_sum = torch.clamp(exp_int + exp_max, max=iv.INT32_MAX)
    factor = torch.floor(rdiv(iv.INT32_MAX, exp_sum))
    sig = torch.floor(exp_int * factor / 2 ** (31 - output_bit + 1))
    return _requant(x * sig, m_gelu)


def table_form(h, s_gelu, m_gelu, output_bit=8, n=23, fast_q=False):
    """ShiftGELU + requant of int8-valued rows ``h`` [..., H] as the kernels
    compute it: each element looked up in its row max's entries."""
    table = launch_table(s_gelu, m_gelu, output_bit, n, fast_q)
    xmax = torch.amax(h, dim=-1, keepdim=True)
    return table[(xmax + 128).long(), (h + 128).long()]


def _every_pair():
    """Row r has max xmax = r - 128 and holds every x in [-128, xmax]."""
    grid = torch.arange(-128.0, 128.0)
    return torch.minimum(grid[None, :], grid[:, None])          # [256, 256]


@pytest.mark.parametrize("fast_q", [False, True])
@pytest.mark.parametrize("s_gelu", SCALES)
def test_table_form_matches_shift_gelu_int(s_gelu, fast_q):
    h = _every_pair()
    for m in M_GELU:
        y, _ = iv.shift_gelu_int(h, s_gelu, 8, fast_q=fast_q)
        want = _requant(y, m)
        got = table_form(h, s_gelu, m, fast_q=fast_q)
        assert torch.equal(got, want), (s_gelu, m, fast_q)


@pytest.mark.parametrize("fast_q", [False, True])
def test_table_form_matches_jax_shift_gelu(fast_q):
    """Random rows of DeiT-S's hidden width through JAX's ``_shift_gelu``
    and its ``_requant``, the Pallas MLP kernel's own steps."""
    rng = np.random.default_rng(0)
    h = np.clip(np.round(rng.normal(0, 32, (64, 1536))), -128, 127).astype(np.float32)
    h[:8] = np.minimum(h[:8], rng.integers(-128, 0, (8, 1)))   # low row maxima
    s_gelu, m = CALIBRATED_S_GELU_IVIT[0], M_GELU[0]
    s_sig = jnp.float32(s_gelu) * 1.702
    want = jblk._requant(jblk._shift_gelu(jnp.asarray(h), s_sig, 8, 23, fast_q),
                         jnp.float32(m), 8)
    got = table_form(torch.from_numpy(h), s_gelu, m, fast_q=fast_q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

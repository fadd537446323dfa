"""Swin's window attention on the token-order stream (``swin_attn_block``'s
``grid``: the stream [B, res*res, C] as the blocks hand it on, whose roll
and window partition the call makes itself; the port's fused engine runs it
so, where JAX rolls and partitions around its kernel,
``ivit_tpu/engine/swin_int.py:551-590``), bit-exact against the JAX package
on the CPU (tolerance 0):

* the moved helpers ``models.swin.to_windows`` / ``from_windows`` against
  JAX's roll + partition and reverse + roll;
* the plain version with ``grid`` against JAX ``swin_attn_block_p``
  (interpret mode) between those, and against the port's windowed plain
  version between the helpers: shifted and unshifted blocks, int16 and int8
  input, res = ws, the four family mixes, the hoisted ``ln_in`` in token
  order;
* a grid that does not tile the stream raises;
* the plain engine's window attention (``_attn_unfused``) against JAX's.

On the card: ``tests/test_torch_port_cuda.py`` and
``tests/test_torch_port_swin_b384.py`` (the kernel's row map).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_swin import (IBERT, IVIT, MIX_IDS, MIXES, _attn_kw,  # noqa: E402
                                  _eq, _jax_ln_in, _small_spec, _stream, _to_jax)

from ivit_tpu.engine import swin_int as jswin  # noqa: E402
from ivit_tpu.ops.pallas import block as jblk  # noqa: E402
from ivit_tpu_torch.engine import swin_int as tswin  # noqa: E402
from ivit_tpu_torch.engine.convert import params_to_torch  # noqa: E402
from ivit_tpu_torch.models import swin as tgeo  # noqa: E402
from ivit_tpu_torch.ops.kernels import block as kb  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as every port CPU test file (ROADMAP, Tier-1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (``grid``: the stream [B, res*res, C] as the blocks hand it on; the port's
# fused engine runs it so, JAX rolls and partitions around its kernel,
# ``swin_int.py:551-590``)

def _jax_windows(x, res, ws, shift):
    xw = jnp.asarray(x).reshape(x.shape[0], res, res, -1)
    if shift:
        xw = jswin._roll_i(xw, (-shift, -shift), (1, 2))
    return jswin._window_partition_i(xw, ws)


def _jax_tokens(yw, b, res, ws, shift):
    y = jswin._window_reverse_i(yw.reshape(-1, ws, ws, yw.shape[-1]), ws, res, res)
    if shift:
        y = jswin._roll_i(y, (shift, shift), (1, 2))
    return y.reshape(b, res * res, -1)


@pytest.mark.parametrize("res,shift", [(14, 0), (14, 3), (21, 2), (7, 0)])
@pytest.mark.parametrize("bits", [16, 8])
def test_window_helpers_match_jax_fused_branch(res, shift, bits):
    """``models.swin.to_windows`` / ``from_windows`` (the plain engine's
    and the plain version's) are JAX's roll + partition and reverse + roll,
    and invert each other."""
    x = _stream((2, res * res, 8), bits, seed=res + shift)
    wins = tgeo.to_windows(torch.from_numpy(x), 2, res, 8, 7, shift)
    _eq(wins.numpy(), _jax_windows(x, res, 7, shift))
    back = tgeo.from_windows(wins, 2, res, 8, 7, shift)
    _eq(back.numpy(), x)
    _eq(back.numpy(), _jax_tokens(jnp.asarray(wins.numpy()), 2, res, 7, shift))


def _check_token_order(blk, mix, heads, res, shift, x, ln_in=None, fasts=(True,)):
    """The call on the token-order stream against JAX's kernel between its
    roll + partition and reverse + roll, and against the port's windowed
    plain version between the moved helpers."""
    b, c = x.shape[0], x.shape[2]
    nw = (res // 7) ** 2
    for fast in fasts:
        jwin = (lambda t: None if t is None else _jax_windows(t, res, 7, shift))
        want = _jax_tokens(jblk.swin_attn_block_p(
            jwin(x), s_ln=jnp.asarray(blk["s_ln1"]), interpret=True, ln_in=jwin(ln_in),
            **_attn_kw(blk, mix, fast, heads, nw, shift, jnp.asarray)), b, res, 7, shift)
        kw = _attn_kw(blk, mix, fast, heads, nw, shift, torch.as_tensor)
        t_ln = None if ln_in is None else torch.tensor(ln_in)
        got = kb.swin_attn_block(torch.from_numpy(x), ln_in=t_ln, grid=(res, 7, shift), **kw)
        assert got.dtype == torch.int16 and got.shape == x.shape
        _eq(got.numpy(), want)
        win = (lambda t: None if t is None else tgeo.to_windows(t, b, res, c, 7, shift))
        windowed = kb.swin_attn_block_ref(win(torch.from_numpy(x)), ln_in=win(t_ln), **kw)
        _eq(got.numpy(), tgeo.from_windows(windowed, b, res, c, 7, shift).numpy())


@pytest.mark.parametrize("mix", MIXES, ids=MIX_IDS)
def test_swin_attn_token_order_matches_pallas(mix):
    """Stage 0's shifted block on the int16 stream (res 14, 4 windows an
    image), stage 1's first block on a merge's int8 output (res = ws)."""
    spec = _small_spec(mix)
    blocks = [b for b in spec.params["blocks"] if "merge" not in b]
    fasts = (False, True) if mix == IVIT else (True,)
    _check_token_order(blocks[1], mix, 2, 14, 3, _stream((2, 196, 32), 16, seed=6),
                       fasts=fasts)
    _check_token_order(blocks[2], mix, 4, 7, 0, _stream((2, 49, 64), 8, seed=7),
                       fasts=fasts)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("mix", [IVIT, IBERT], ids=["ivit", "ibert"])
def test_swin_attn_token_order_hoisted_ln_matches_pallas(mix, shift):
    """``ln_in`` in token order too (the LN is row-local: JAX's hoisted LN
    of the token stream)."""
    spec = _small_spec(mix)
    blk = spec.params["blocks"][1 if shift else 0]
    x = _stream((2, 196, 32), 16, seed=8)
    _check_token_order(blk, mix, 2, 14, shift, x, ln_in=_jax_ln_in(spec, x, blk))


@pytest.mark.parametrize("grid,tokens,n_windows", [
    ((14, 7, 7), 196, 4), ((14, 7, -1), 196, 4), ((14, 5, 0), 196, 4),
    ((14, 7, 3), 195, 4), ((14, 7, 3), 196, 1), ((7, 14, 0), 49, 1)],
    ids=["shift_ws", "shift_neg", "res_not_whole_windows", "tokens", "n_windows",
         "window_past_res"])
def test_swin_attn_block_refuses_a_bad_grid(grid, tokens, n_windows):
    blk = _small_spec(IVIT).params["blocks"][1]
    kw = _attn_kw(blk, IVIT, True, 2, n_windows, 3, torch.as_tensor)
    with pytest.raises(ValueError, match="grid"):
        kb.swin_attn_block(torch.from_numpy(_stream((2, tokens, 32), 16, seed=9)),
                           grid=grid, **kw)


@pytest.mark.parametrize("shift", [0, 3])
def test_attn_unfused_matches_jax(shift):
    """The plain engine's window attention (``_attn_unfused``, on the moved
    helpers) against JAX's ``_swin_attn_unfused``, one stage-0 block."""
    spec = _small_spec(IBERT)
    jspec = _to_jax(spec)
    i = 1 if shift else 0
    x = _stream((2, 196, 32), 16, seed=10 + shift)
    want = jswin._swin_attn_unfused(jspec.config, jspec.params["blocks"][i],
                                    jnp.asarray(x), 2, 14, 32, 2, 7, 49, shift)
    blk = params_to_torch(spec.params, "cpu")["blocks"][i]
    got = tswin._attn_unfused(spec.config, blk, torch.from_numpy(x), 2, 14, 32, 2, 7,
                              shift)
    _eq(got.numpy(), want)

"""Swin geometry (counterpart of ``ivit_tpu/models/swin.py:34-83``; the QAT
model itself is not ported yet).

The relative-position index and the shift mask are freeze-time constants,
built in numpy; the window partition and its reverse are token
permutations of the engine's integer stream, in torch.
"""

from __future__ import annotations

import numpy as np


def window_partition(x, window_size: int):
    """[B, H, W, C] -> [B*nW, ws*ws, C] (swin_quant.py:18-32)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window_size, window_size,
                  w // window_size, window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size * window_size, c)


def window_reverse(windows, window_size: int, h: int, w: int):
    """[B*nW, ws*ws, C] -> [B, H, W, C] (swin_quant.py:35-50)."""
    b = windows.shape[0] // (h * w // window_size // window_size)
    x = windows.reshape(b, h // window_size, w // window_size,
                        window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(window_size: int) -> np.ndarray:
    """Pairwise relative-position lookup table [N, N], N = ws*ws
    (swin_quant.py:79-94)."""
    coords = np.stack(np.meshgrid(np.arange(window_size),
                                  np.arange(window_size),
                                  indexing="ij"))           # [2, ws, ws]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]               # [2, N, N]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1)


def attention_mask(resolution, window_size: int, shift_size: int):
    """0/-100 additive mask [nW, N, N] of the shifted windows
    (swin_quant.py:223-247)."""
    h, w = resolution
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window_size), slice(-window_size, -shift_size),
               slice(-shift_size, None)):
        for ws in (slice(0, -window_size), slice(-window_size, -shift_size),
                   slice(-shift_size, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, h // window_size, window_size,
                          w // window_size, window_size, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window_size * window_size)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)

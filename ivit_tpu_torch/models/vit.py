"""Bitwidth vector of the quantized ViT (counterpart of
``ivit_tpu/models/vit.py::BitWidths``; the QAT model itself is not ported
yet)."""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class BitWidths:
    """The 8-position bitwidth vector (ref quant_train.py:151-157,295-319)."""

    patch_embed: int = 8
    pos_encoding: int = 8
    block_input: int = 8
    attention_out: int = 8
    softmax: int = 8
    mlp_out: int = 8
    norm2_in: int = 8
    att_block_out: int = 8

    def to_list(self) -> Sequence[int]:
        return [self.patch_embed, self.pos_encoding, self.block_input,
                self.attention_out, self.softmax, self.mlp_out,
                self.norm2_in, self.att_block_out]

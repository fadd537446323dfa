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

    @classmethod
    def from_spec(cls, spec) -> "BitWidths":
        """Parse ``8`` / ``"8"`` / ``"8,8,8,8,16,8,16,8"`` (the reference's
        INT16 run) or pass a ``BitWidths`` through."""
        if isinstance(spec, BitWidths):
            return spec
        parts = [int(p) for p in str(spec).split(",")]
        if len(parts) == 1:
            return cls(*(parts * 8))
        if len(parts) != 8:
            raise ValueError(f"bitwidth spec needs 1 or 8 values, got {spec!r}")
        return cls(*parts)

    def to_list(self) -> Sequence[int]:
        return [self.patch_embed, self.pos_encoding, self.block_input,
                self.attention_out, self.softmax, self.mlp_out,
                self.norm2_in, self.att_block_out]

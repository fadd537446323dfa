"""``swin_attn_block``'s share of its roofline: the bound time of the
forward's window-attention half-blocks
(``gpubench/kernels/swin_attn_block.py``) over the device time of the three
kernels the wrapper launches (in a Swin cell the two row GEMMs are this
wrapper's)."""

from gpubench.kernels import swin_attn_block
from gpubench.roofline import reader

LAYER = "Kernels"
UNIT = "%"
MOVES = "img_per_s"
KERNELS = ("ln_qkv_wgmma_kernel", "swin_core_mma_kernel", "proj_wgmma_kernel")
ANCHORS = ("swin_core_mma_kernel",)
read = reader(swin_attn_block.calls, KERNELS, ANCHORS)

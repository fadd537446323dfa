"""``attn_block``'s share of its roofline: the bound time of the forward's
ViT attention half-blocks (``gpubench/kernels/attn_block.py``) over the
device time of the three kernels the wrapper launches (in a ViT cell the
two row GEMMs are this wrapper's)."""

from gpubench.kernels import attn_block
from gpubench.roofline import reader

LAYER = "Kernels"
UNIT = "%"
MOVES = "img_per_s"
KERNELS = ("ln_qkv_wgmma_kernel", "attn_core_mma_kernel", "proj_wgmma_kernel")
ANCHORS = ("attn_core_mma_kernel",)
read = reader(attn_block.calls, KERNELS, ANCHORS)

"""``mlp_block``'s share of its roofline: the bound time of the forward's
MLP half-blocks (``gpubench/kernels/mlp_block.py``) over the device time of
the kernels the wrapper launches."""

from gpubench.kernels import mlp_block
from gpubench.roofline import reader

LAYER = "Kernels"
UNIT = "%"
MOVES = "img_per_s"
KERNELS = ("mlp_wgmma_kernel", "mlp_block_kernel", "gelu_lut_table_kernel",
           "shift_gelu_table_kernel")
ANCHORS = ("mlp_wgmma_kernel", "mlp_block_kernel")
read = reader(mlp_block.calls, KERNELS, ANCHORS)

"""Device time per forward of every kernel that is not one of the port's
named kernels (``ivit_tpu_torch/csrc``): the torch operations around the
kernels, from the profiled stretch."""

from gpubench.trace import kernel_name

LAYER = "Outside the kernels"
UNIT = "ms"
MOVES = "img_per_s"
CSRC_KERNELS = frozenset({
    "ln_qkv_wgmma_kernel", "attn_core_mma_kernel", "proj_wgmma_kernel",
    "swin_core_mma_kernel", "mlp_wgmma_kernel", "mlp_block_kernel",
    "gelu_lut_table_kernel", "shift_gelu_table_kernel", "ppoly_table_kernel",
    "shiftmax_kernel", "shift_gelu_requant_kernel"})


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    outside = sum(o.end - o.start for o in tr.kernels
                  if kernel_name(o.name) not in CSRC_KERNELS)
    return outside / tr.batches * 1e3

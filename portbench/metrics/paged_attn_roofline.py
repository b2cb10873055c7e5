"""Share (%) of the paged-attention kernels' device time that their least
time takes: the chunk and decode calls of the traced slice counted by
``roofline.paged_attn_least_s`` against every kernel whose name holds
"paged" (split, combine, wgmma chunk, SIMT). Layer: kernels."""

from portbench import roofline


def read(ctx):
    dev = ctx.slice.kernels_matching("paged")
    if not dev:
        return None
    return 100.0 * roofline.paged_attn_least_s(ctx.m, ctx.slice_steps) / dev

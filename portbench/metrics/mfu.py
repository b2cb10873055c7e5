"""The whole step's share (%) of the card's bf16 peak: the forward
operations of every prompt token and decode row served in the traced slice
(``roofline.work_flops``) over the slice's length. Layer: model step."""

from portbench import roofline


def read(ctx):
    flops = roofline.work_flops(ctx.m, ctx.slice_steps)
    if not flops:
        return None
    return 100.0 * flops / (ctx.slice.window_s * roofline.BF16_FLOP_S)

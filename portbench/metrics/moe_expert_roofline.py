"""Share (%) of the expert products' device time that their least time
takes: every forward of the traced slice counted by
``roofline.moe_expert_least_s`` (each routed choice's three products, the
reachable experts' weights read once) against the device time of the
kernels launched by the ``aten::bmm`` calls with an expert product's
shapes (``trace.expert_shapes``): the experts' gate, up and down products
of ``jobs/model.py`` ``_moe_mlp_capacity``, and not the projections that
``einsum`` also sends through ``aten::bmm``. Layer: MoE MLP."""

from portbench import roofline


def read(ctx):
    dev = ctx.slice.bmm_s
    if not dev:
        return None
    return 100.0 * roofline.moe_expert_least_s(ctx.m, ctx.slice_steps) / dev

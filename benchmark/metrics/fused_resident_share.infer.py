"""fused_resident_share.infer: the weight-resident fused block kernels' share
of the fused blocks' device time in the traced slice, %: kernels named
``fused_block_resident`` over kernels named ``fused_block`` (which holds
them). 0 where the resident design never ran; None without a trace or
without fused block kernels in it."""


def read(ctx):
    t = ctx.trace
    spent = t.kernel_us("fused_block") if t is not None else 0.0
    if not spent:
        return None
    return 100.0 * t.kernel_us("fused_block_resident") / spent

"""fused_xa_share.classify: the split design's share of the fused blocks'
device time in the traced slice, %: kernels named ``fused_block_xa`` (the
xa pass, ``fused_block_xa_kernel``, and the tail that reads its output,
``fused_block_xa_tail_kernel``) over kernels named ``fused_block`` (which
holds them). 0 where the split design never ran; None without a trace or
without fused block kernels in it."""


def read(ctx):
    t = ctx.trace
    spent = t.kernel_us("fused_block") if t is not None else 0.0
    if not spent:
        return None
    return 100.0 * t.kernel_us("fused_block_xa") / spent

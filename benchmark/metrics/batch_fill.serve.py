"""batch_fill.serve: requests per batch the server's batcher formed over the
window, from its counters (``serving._Stats``) read before and after."""


def read(ctx):
    batches = ctx.counters.get("batches")
    return ctx.counters["batched_requests"] / batches if batches else None

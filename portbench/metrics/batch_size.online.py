"""batch_size.online: single-user requests per batch that the server's
``_Batcher`` scored (``batched_requests / batches`` of its ``stats``
reply at the end of the window)."""


def read(ctx):
    s = ctx.stats or {}
    if not s.get("batches"):
        return None
    return s["batched_requests"] / s["batches"]

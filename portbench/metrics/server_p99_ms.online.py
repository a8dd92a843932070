"""server_p99_ms.online: the server's own 99th percentile of request
latency (``serve/server.LatencyStats``, log buckets of ~4.4%, upper
edges) from its ``stats`` reply at the end of the window. It times a
request from the server's reading of the line to its reply; the
connection's queue and the client's wait are outside it."""


def read(ctx):
    lat = (ctx.stats or {}).get("latency") or {}
    return lat.get("p99_ms")

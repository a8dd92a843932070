"""Open-loop load generator: a child process of an ``open_loop`` run.

Sends each request of a schedule at its due time on one of a fixed pool
of connections (an idle one if there is one, else the least loaded one,
where the request waits behind the others: a pool's queueing is part of
what a caller feels), whatever the replies are doing, and times each
request from its due time to the last byte of its reply. Writes, for
every request, when it was sent and answered, whether it failed, and the
items served.

    python open_loop_client.py --port P --schedule S.npz --out O.npz
        [--connections 64] [--wait 60]

Prints one line ``{"t0": <perf_counter of due time 0>}`` once every
connection is open; ``perf_counter`` is the system's monotonic clock, so
the parent can read it against its own.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import time

import numpy as np


async def drive(host, port, due, users, n, conns, wait, go_delay):
    N = len(due)
    sent = np.full(N, np.nan)
    done = np.full(N, np.nan)
    status = np.full(N, 2, np.int8)  # 0 answered, 1 error reply, 2 none
    items = np.full((N, n), -1, np.int32)
    pool = [await asyncio.open_connection(host, port) for _ in range(conns)]
    queues = [collections.deque() for _ in range(conns)]
    answered = [0]
    all_in = asyncio.Event()

    async def read(c):
        reader = pool[c][0]
        while True:
            line = await reader.readline()
            if not line:
                return
            k = queues[c].popleft()
            done[k] = time.perf_counter()
            try:
                obj = json.loads(line)
            except ValueError:
                obj = {"error": "unparsable reply"}
            if "error" in obj or "items" not in obj:
                status[k] = 1
            else:
                got = obj["items"][:n]
                items[k, :len(got)] = got
                status[k] = 0
            answered[0] += 1
            if answered[0] == N:
                all_in.set()

    readers = [asyncio.create_task(read(c)) for c in range(conns)]
    t0 = time.perf_counter() + go_delay
    print(json.dumps({"t0": t0}), flush=True)
    turn = 0
    for k in range(N):
        delay = t0 + due[k] - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        idle = [c for c in range(conns) if not queues[(turn + c) % conns]]
        c = ((turn + idle[0]) % conns if idle
             else min(range(conns), key=lambda j: len(queues[j])))
        turn = c + 1
        queues[c].append(k)
        pool[c][1].write(f"{int(users[k])}\n".encode())
        sent[k] = time.perf_counter()
        if k % 64 == 0:
            await asyncio.sleep(0)  # let the readers take what has come
    if N:
        try:
            await asyncio.wait_for(all_in.wait(), t0 + due[-1] + wait
                                   - time.perf_counter())
        except asyncio.TimeoutError:
            pass
    for _, w in pool:
        w.close()
    for t in readers:
        t.cancel()
    await asyncio.gather(*readers, return_exceptions=True)
    return t0, sent, done, status, items


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--schedule", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--connections", type=int, default=64)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--wait", type=float, default=60.0)
    ap.add_argument("--go-delay", type=float, default=0.5)
    a = ap.parse_args(argv)
    with np.load(a.schedule) as z:
        due, users = z["due"], z["users"]
    t0, sent, done, status, items = asyncio.run(drive(
        a.host, a.port, due, users, a.n, a.connections, a.wait, a.go_delay))
    np.savez(a.out, t0=t0, sent=sent, done=done, status=status, items=items)


if __name__ == "__main__":
    main()

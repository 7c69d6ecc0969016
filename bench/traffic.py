"""The one general traffic generator: a cell's mix is data, read here.

A workload file's ``mix`` holds ``threads``: one closed-loop client for
each entry, at that many threads, each waiting for its own result's
readiness on the device before its next ``DecodeService.decode``.  One
thread enqueues for all, so work is queued ahead of the device, and the
clients take turns, so each issues as many requests.  Assets come in
blocks of one permutation of the catalog each, drawn from the seed, so
every seed decodes each asset equally often, in another order.
"""

from __future__ import annotations

import dataclasses
import random
import time
from collections import deque

import numpy as np
import torch

from .tracing import span


@dataclasses.dataclass(slots=True)
class Req:
    asset: int                 # catalog index
    threads: int
    due: float                 # s after the window's start
    done: float | None = None  # s after the window's start, output ready
    status: str = "pending"    # ok once its output is ready
    enqueue_s: float = 0.0     # host time of the call (the bench's span)


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.rng = random.Random(seed)

    def offer(self, make):
        """Count one item; keep ``make()`` if it is drawn."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = make()


def asset_order(n_assets: int, seed: int):
    """Catalog indices, one permutation of the catalog after another."""
    rng = np.random.default_rng([seed, 2])
    while True:
        yield from rng.permutation(n_assets).tolist()


def _ready_event(out: torch.Tensor):
    if out.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def closed_decode(svc, names, mix, seconds, seed, traced, sample: Reservoir):
    """Closed-loop clients on ``DecodeService.decode``.  Returns every
    request issued; ``sample`` keeps some completed outputs.  Each client
    issues until the window's length has passed; the window closes when
    the last of them is ready."""
    order = asset_order(len(names), seed)
    reqs, inflight = [], deque()
    t0 = time.perf_counter()

    def issue(threads: int):
        a = next(order)
        r = Req(a, threads, time.perf_counter() - t0)
        with span("decode", traced):
            t = time.perf_counter()
            out = svc.decode(names[a], threads)
            r.enqueue_s = time.perf_counter() - t
        reqs.append(r)
        inflight.append((r, out, _ready_event(out)))

    for threads in mix["threads"]:
        issue(int(threads))
    while inflight:
        r, out, ev = inflight.popleft()
        if ev is not None:
            with span("wait", traced):
                ev.synchronize()
        r.done = time.perf_counter() - t0
        r.status = "ok"
        sample.offer(lambda: (r, out))
        if r.done < seconds:
            issue(r.threads)
    return reqs

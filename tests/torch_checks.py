"""Checks shared by the port's tests and ``chip_smoke.py``: the split
planner's inputs for a batch of contents, the round in which each planned
slot was won, and a card session's walk beside its plain version.

Imports torch and the port only (never jax or the JAX package), so
``chip_smoke.py`` can import it with ``tests/`` on its path.
"""

import numpy as np
import torch

from repro_torch.core.encode import ops
from repro_torch.core.encode.executors import scan_grids
from repro_torch.core.rans import RansParams, StaticModel
from repro_torch.core.vectorized import (_walk_batch_impl,
                                         _walk_batch_symbol_impl)
from repro_torch.kernels.rans_encode import rans_encode


def plan_inputs(contents, ways, n_splits, device):
    """The planner's positional arguments for a batch of symbol arrays and
    their ``y_of_word``: a static n_bits-11 model built from the contents'
    symbols alone, the encode wrapper on ``device`` (its plain version on
    the CPU), and the emission log laid out as ``ingest_batch`` lays it out
    (no lead slots; five padding words past the largest word count)."""
    model = StaticModel.from_symbols(np.concatenate(contents), 256,
                                     RansParams(n_bits=11, ways=ways))
    sym, active, _, x0 = scan_grids(
        [(0, torch.as_tensor(c.astype(np.int32), device=device), None)
         for c in contents], ways, device, False)
    f, F = (torch.as_tensor(np.asarray(a).astype(np.int32), device=device)
            for a in (model.f, model.F))
    words, masks, ys, _, _ = rans_encode.encode_scan(sym, active, f, F, x0,
                                                     n_bits=11)
    csum, last, n_words = ops.emission_layout(masks)
    _, kw, yw = ops.compact_emissions(words, ys, masks, csum,
                                      int(n_words.max()) + 5)
    as_i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                    device=device)
    return (kw, csum, last, ys, n_words.int(),
            as_i32([len(c) for c in contents]), as_i32(n_splits)), yw


def won_rounds(q, found, cover, csum, n_words, n_symbols, n_splits, *,
               window: int):
    """The round in which each found slot was won (-1 where none was), as
    int64[B, S], recovered from a plan (``found``, ``q``) and the cover
    ``c`` (host tensors): the rounds' windows are nested and every round
    before the winning one had no valid candidate, so a slot's round is the
    first whose window holds its winner."""
    B, S = q.shape
    rounds = torch.full((B, S), -1, dtype=torch.int64)
    qs, fs = q.tolist(), found.tolist()
    for b, (NW, N, M) in enumerate(zip(n_words.tolist(), n_symbols.tolist(),
                                       n_splits.tolist())):
        c_prev = min_q = 0
        for m in range(S):
            if not fs[b][m]:
                break
            T = -(-(N - c_prev) // (M - m))
            center = int(csum[b, c_prev + T - 1])
            rounds[b, m] = next(
                r for r in range(rans_encode.ROUNDS)
                if max(min_q, center - window * (2 * r + 1)) <= qs[b][m]
                <= min(NW - 1, center + window * (2 * r + 1)))
            c_prev, min_q = int(cover[b, qs[b][m]]), qs[b][m] + 1
    return rounds


def session_walk(sess, batch, stream, n_symbols):
    """One request through a session's executor call and through the plain
    walk of its layout on the same arguments: ``(layout, pairs)``, where
    ``pairs`` holds ``(executor, plain)`` for the output and, for the
    pointer layout, the final pointers after it."""
    plan = sess.prepare(batch, stream, n_symbols)
    got = sess.executor.lower(plan)(*plan.args, n_steps=plan.n_steps,
                                    n_symbols=plan.n_symbols,
                                    covered=plan.covered)
    plain = (_walk_batch_symbol_impl if plan.layout == "symbol"
             else _walk_batch_impl)
    ref = plain(*plan.args, **plan.statics, n_steps=plan.n_steps,
                n_symbols=plan.n_symbols)
    if plan.layout == "pointer":
        return plan.layout, [(got[0], ref[0]), (got[1], ref[1])]
    return plan.layout, [(got, ref)]

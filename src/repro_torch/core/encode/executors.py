"""The ingest executor: request preparation and the pipeline call.

    plan(symbols, n_splits)          -> EncodePlan   (grids on the device)
    plan_extend(delta, ..., head, x0) -> EncodePlan  (suffix re-ingest)
    plan_batch(contents, n_splits)    -> EncodePlan  (a leading content axis)
    run(plan)                         -> dict of device tensors
    encode_scan_args(symbols, f, F, ways, device, ...)  (one content's
                                      encode-scan wrapper arguments)

One executor serves both devices: the kernel wrappers under
:func:`~repro_torch.core.encode.ops.ingest_pipeline` launch the Hopper
kernels on CUDA tensors and run their plain torch versions on CPU tensors.
Contents enter as 1-D int32 symbol tensors already on the device; the
grids, their padding and the active flags are built there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...kernels.rans_encode import rans_encode
from .ops import ingest_pipeline
from .plan import EncodePlan


def scan_grids(rows, ways: int, device, adaptive: bool,
               x0: torch.Tensor | None = None) -> tuple:
    """The encode scan's [B, G, W] grids for ``rows`` of ``(head, symbols,
    ctx)``: each content's symbols start ``head`` inert lead slots into its
    grid row, and inert padding follows.  Returns ``(sym_gw, active_gw,
    ctx_gw, x0)``; ``ctx_gw`` is None for a static model, and ``x0``
    defaults to 2^16 in every way."""
    W = ways
    B = len(rows)
    G = max(1, max(-(-(h + s.numel()) // W) for h, s, _ in rows))
    sym = torch.zeros((B, G * W), dtype=torch.int32, device=device)
    active = torch.zeros((B, G * W), dtype=torch.bool, device=device)
    ctx_gw = (torch.zeros((B, G * W), dtype=torch.int32, device=device)
              if adaptive else None)
    for b, (head, syms, ctx) in enumerate(rows):
        n = syms.numel()
        sym[b, head:head + n] = syms
        active[b, head:head + n] = True
        if adaptive:
            if ctx is None or ctx.numel() != n:
                raise ValueError(
                    "adaptive encode needs a per-symbol ctx map covering "
                    f"all {n} symbols")
            ctx_gw[b, head:head + n] = ctx
    if x0 is None:
        x0 = torch.full((B, W), 1 << 16, dtype=torch.int32, device=device)
    return (sym.view(B, G, W), active.view(B, G, W),
            None if ctx_gw is None else ctx_gw.view(B, G, W), x0)


def encode_scan_args(symbols, f, F, ways: int, device, head: int = 0,
                     ctx=None, x0=None) -> tuple:
    """One content's positional arguments of the encode-scan wrappers
    (:func:`~repro_torch.kernels.rans_encode.rans_encode.encode_scan` and
    its plain version) on ``device``, from host arrays: ``(sym_gw,
    active_gw, f_tab, F_tab, x0)`` as [1, G, W] grids, plus ``ctx_gw`` when
    a context map is given.  ``x0`` is u32[W] (default 2^16 each)."""
    as_t = lambda a, dt: torch.as_tensor(  # noqa: E731
        np.asarray(a).astype(dt), device=device)
    x0_t = None if x0 is None else as_t(
        np.asarray(x0, np.uint32).view(np.int32), np.int32).reshape(1, ways)
    sym, active, ctx_gw, x0_t = scan_grids(
        [(head, as_t(symbols, np.int32).reshape(-1),
          None if ctx is None else as_t(ctx, np.int32).reshape(-1))],
        ways, device, ctx is not None, x0_t)
    args = (sym, active, as_t(f, np.int32), as_t(F, np.int32), x0_t)
    return args if ctx_gw is None else args + (ctx_gw,)


class EncodeExecutor:
    """``f_tab``/``F_tab`` are the session's device-resident frequency
    tables — ``[A]``/``[A + 1]`` for a static model, ``[C, A]``/``[C, A + 1]``
    for a context (adaptive) model.  The executor builds the model's
    encoder records (``table``) once, here, and passes them to every
    pipeline call."""

    def __init__(self, f_tab: torch.Tensor, F_tab: torch.Tensor, *,
                 n_bits: int, ways: int, adaptive: bool, window: int):
        self.f_tab = f_tab
        self.F_tab = F_tab
        self.table = rans_encode.encoder_table(f_tab, F_tab, n_bits)
        self.n_bits = n_bits
        self.ways = ways
        self.adaptive = adaptive
        self.window = window
        self.device = f_tab.device

    def _plan(self, rows, n_symbols, n_splits, x0=None) -> EncodePlan:
        sym, active, ctx_gw, x0 = scan_grids(rows, self.ways, self.device,
                                             self.adaptive, x0)
        as_t = lambda v: torch.as_tensor(v, dtype=torch.int32,  # noqa: E731
                                         device=self.device)
        args = (sym, active, self.f_tab, self.F_tab, as_t(n_symbols),
                as_t(n_splits), ctx_gw, x0)
        return EncodePlan(args=args, n_symbols=max(n_symbols))

    def plan(self, symbols: torch.Tensor, n_splits: int,
             ctx: torch.Tensor | None = None) -> EncodePlan:
        n = symbols.numel()
        return self._plan([(0, symbols, ctx)], [n], [n_splits])

    def plan_extend(self, delta: torch.Tensor, n_splits: int, head: int,
                    x0: np.ndarray,
                    ctx: torch.Tensor | None = None) -> EncodePlan:
        """Suffix re-ingest plan: resume each way's state chain from ``x0``
        and encode only the appended ``delta``.

        The suffix grid opens with ``head = N_old % W`` inert lead slots so
        each way's phase matches its absolute position in the grown
        content; every suffix emission's (group, way) coordinate is then
        the absolute one minus the ``(N_old // W) * W`` grid origin, which
        the session's splice adds back.
        """
        W = self.ways
        if not 0 <= head < W:
            raise ValueError(f"head must be in [0, {W}), got {head}")
        x0_t = torch.as_tensor(np.asarray(x0, np.uint32).view(np.int32),
                               device=self.device).reshape(1, W)
        return self._plan([(head, delta, ctx)], [head + delta.numel()],
                          [n_splits], x0=x0_t)

    def plan_batch(self, contents: Sequence[torch.Tensor], n_splits,
                   ctxs: Sequence[torch.Tensor] | None = None) -> EncodePlan:
        """One plan for B contents: grids as long as the longest content,
        shorter rows padded with inactive slots."""
        B = len(contents)
        if B == 0:
            raise ValueError("plan_batch needs at least one content")
        n_splits = ([int(n_splits)] * B if np.isscalar(n_splits)
                    else [int(n) for n in n_splits])
        if len(n_splits) != B:
            raise ValueError("n_splits must be a scalar or one per content")
        rows = [(0, c, None if ctxs is None else ctxs[i])
                for i, c in enumerate(contents)]
        return self._plan(rows, [c.numel() for c in contents], n_splits)

    def run(self, plan: EncodePlan) -> dict:
        return ingest_pipeline(*plan.args, n_bits=self.n_bits,
                               ways=self.ways, window=self.window,
                               table=self.table)

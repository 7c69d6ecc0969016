"""EncodePlan: one ingest request, prepared once into executor-ready form.

The kernels take every size at run time, so a plan needs no cache key and
no bucketed shapes: it holds the request's device arguments, laid out as
[B, G, W] group grids with ``G`` the groups the longest content needs, and
its real sizes.  ``key`` names the request's size class for the profiler
only.  Padding is inert: padded slots and resume lead slots carry
``active = False`` (no state change, no emission), and a content's split
slots past its own ``n_splits - 1`` never emit.
"""

from __future__ import annotations

import dataclasses

from ..engine.plan import pow2_bucket

__all__ = ["EncodePlan"]


@dataclasses.dataclass(frozen=True)
class EncodePlan:
    """A prepared ingest request.

    ``args`` is the positional argument tuple of
    :func:`~repro_torch.core.encode.ops.ingest_pipeline`: ``(sym_gw,
    active_gw, f_tab, F_tab, n_symbols, n_splits, ctx_gw, x0)``, on the
    session's device.  ``n_symbols`` is the request's real symbol count
    (the largest content's, for a batch; each content's is in ``args[4]``).
    """

    args: tuple
    n_symbols: int

    @property
    def key(self) -> tuple:
        """The profiler's row for this request: contents, groups at their
        pow2 bucket (which bounds the rows), ways, and whether the model is
        adaptive.  No cache reads it."""
        B, G, W = self.args[0].shape
        return (B, pow2_bucket(G), W, self.args[6] is not None)

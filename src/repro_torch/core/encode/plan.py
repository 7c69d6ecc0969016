"""EncodePlan: one ingest request, prepared once into executor-ready form.

The kernels take every size at run time, so a plan needs no cache key and
no bucketed shapes: it holds the request's device arguments, laid out as
[B, G, W] group grids with ``G`` the groups the longest content needs, and
its real sizes.  Padding is inert: padded slots and resume lead slots carry
``active = False`` (no state change, no emission), and a content's split
slots past its own ``n_splits - 1`` never emit.
"""

from __future__ import annotations

import dataclasses

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

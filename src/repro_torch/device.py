"""Device selection shared by the port's entry points.

Every entry point defaults to ``device="cuda"`` and runs on the CPU only
when the caller passes ``device="cpu"``: with no card present a CUDA
request raises instead of drifting to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises for a CUDA device when
    no card is visible and for device types the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain torch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

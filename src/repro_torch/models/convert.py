"""Carrying parameters and train states between the JAX package and the
port.

``params_from_arrays`` turns a nested dict of numpy arrays (the JAX
package's parameters through ``np.asarray``) into the port's tensors on a
device; ``params_to_arrays`` goes the other way.  Both keep the dicts' key
order.  ``state_from_arrays`` carries a train state (params, moments, step
and error-feedback residuals) the same way.  A bf16 array from JAX has
numpy dtype ``bfloat16``, a type that the ``ml_dtypes`` package registers
with numpy; the port does not import that package, so such arrays cross
as their 16-bit patterns (``view(np.int16)`` into ``torch.int16``, then
``view(torch.bfloat16)``), bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _leaf_to_tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.array(a)    # a writable copy: the tensor never aliases the input
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).to(dev).view(torch.bfloat16)
    return torch.from_numpy(a).to(dev)


def _leaf_to_array(t: torch.Tensor) -> np.ndarray:
    if t.dtype != torch.bfloat16:
        return t.detach().cpu().numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise TypeError(
            "numpy knows no bfloat16 type in this process (the ml_dtypes "
            "package registers it); convert the tree with .float() first"
        ) from None
    return t.detach().cpu().view(torch.int16).numpy().view(bf16)


def params_from_arrays(tree: dict, device="cuda") -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (default the card; raises without one)."""
    dev = resolve_device(device)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else _leaf_to_tensor(v, dev)
                for k, v in node.items()}
    return walk(tree)


def params_to_arrays(tree: dict) -> dict:
    """Nested dict of tensors -> the same dict of host numpy arrays (bf16
    tensors as numpy ``bfloat16``, which needs that type registered)."""
    return {k: params_to_arrays(v) if isinstance(v, dict)
            else _leaf_to_array(v) for k, v in tree.items()}


def state_from_arrays(state, device="cuda"):
    """A train state of the JAX package (``params``, ``opt``, ``step`` and
    ``ef`` as arrays, e.g. through ``np.asarray``) -> the port's
    :class:`~repro_torch.runtime.train.TrainState` on ``device``, every
    leaf bit for bit (``ef`` may be None)."""
    from ..runtime.train import TrainState
    dev = resolve_device(device)

    def tree(t):
        return None if t is None else params_from_arrays(t, dev)
    return TrainState(params=tree(state.params), opt=tree(state.opt),
                      step=_leaf_to_tensor(state.step, dev),
                      ef=tree(state.ef))

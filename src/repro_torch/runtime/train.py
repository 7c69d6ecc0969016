"""The train step, in torch.

Counterpart of the JAX package's ``runtime/train.py``.  ``make_train_step``
builds a function ``(state, batch) -> (state, metrics)`` with:

  * the model's next-token CE loss and its gradients (``torch.autograd``
    over the params' leaves; a leaf the loss does not use gets zeros, as
    ``jax.value_and_grad`` gives);
  * optional gradient accumulation over ``accum_steps`` micro-batches cut
    from the batch's leading axis, summed into float32 zeros and divided
    by ``accum_steps`` (the reference's ``lax.scan``, here a Python loop);
  * AdamW with global-norm clipping and float32 moments;
  * metrics as 0-d tensors on the params' device (``loss``, ``lr``,
    ``grad_norm``, ``step``), so a step reads nothing back to the host.

``make_compressed_crosspod_step`` is the cross-pod variant with int8 +
error-feedback gradient sync.  The reference runs it under ``shard_map``,
manual over a ``"pod"`` mesh axis; here a pod is one device of a
:class:`~repro_torch.launch.mesh.DecodeMesh` with that axis (one process,
a device list that may repeat a device), the podded state is one
:class:`TrainState` a pod on its device (the reference's leading pod axis
is the tuple's index), and the all-gather moves each pod's int8 blocks
and scales to every pod's device (``optim.compress.gather_mean``).  Every
pod computes the same mean from the same bytes, so the pod copies stay
bit-equal.  The reference's ``podded_state_specs`` returns a jax
``PartitionSpec`` tree and has no counterpart.

``donate=True`` lets a step write the new params and moments into the
state it was given (the counterpart of a donated jit argument): a
full-size model then holds one copy of its state through the update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..optim import adamw as adamw_lib
from ..optim import compress as compress_lib
from ..optim.adamw import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    step: torch.Tensor
    ef: Any = None        # error-feedback residuals (compressed mode only)


def init_state(params, compress: bool = False) -> TrainState:
    dev = tree_leaves(params)[0].device
    return TrainState(
        params=params, opt=adamw_lib.init_moments(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        ef=compress_lib.init_error_feedback(params) if compress else None)


def _on(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
            .to(device) for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params, batch):
    """``jax.value_and_grad(loss_fn)(params, batch)``: (loss, grads tree),
    each gradient in its param's dtype."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def make_grad_fn(loss_fn: Callable, accum_steps: int = 1):
    """``(params, batch) -> (loss, grads)``: the train step's gradients,
    accumulated over ``accum_steps`` micro-batches of the batch's leading
    axis into float32 zeros and divided by ``accum_steps`` (with one
    micro-batch, the gradients in the params' dtypes)."""

    def grads_of(params, batch):
        if accum_steps == 1:
            return value_and_grad(loss_fn, params, batch)
        micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                              + tuple(v.shape[1:])) for k, v in batch.items()}
        loss = None
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        for i in range(accum_steps):
            l, g = value_and_grad(loss_fn, params,
                                  {k: v[i] for k, v in micro.items()})
            loss = l if loss is None else loss + l
            tree_map(lambda a, b: a.add_(b), acc, g)
            del g
        inv = 1.0 / accum_steps
        return loss * inv, tree_map(lambda g: g.mul_(inv), acc)

    return grads_of


def make_train_step(loss_fn: Callable, schedule: Callable,
                    opt_cfg: adamw_lib.AdamWConfig = adamw_lib.AdamWConfig(),
                    accum_steps: int = 1,
                    compress_axis: Optional[str] = None,
                    donate: bool = False):
    """loss_fn(params, batch) -> 0-d tensor.  The batch's leading dim must
    be divisible by ``accum_steps``; its arrays move to the params'
    device.  ``compress_axis`` names the reference's in-``shard_map`` pod
    axis; the port's cross-pod step is
    :func:`make_compressed_crosspod_step`."""
    if compress_axis is not None:
        raise ValueError("the cross-pod compressed step runs over a device "
                         "list: use make_compressed_crosspod_step")
    grads_of = make_grad_fn(loss_fn, accum_steps)

    def step_fn(state: TrainState, batch) -> tuple[TrainState, dict]:
        dev = state.step.device
        loss, grads = grads_of(state.params, _on(batch, dev))
        lr = schedule(state.step)
        new_params, new_opt, m = adamw_lib.apply_adamw(
            state.params, grads, state.opt, lr, opt_cfg, inplace=donate)
        metrics = {"loss": loss, "lr": lr, **m,
                   "step": state.step.to(torch.float32)}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1, ef=state.ef), metrics

    return step_fn


def podify_state(state: TrainState, mesh) -> tuple:
    """One copy of ``state`` a pod, on each device of ``mesh`` (a
    ``("pod",)`` mesh, :func:`~repro_torch.launch.mesh.make_pod_mesh`); a
    repeated device gets copies of its own.  Each pod's EF residuals are
    ``state.ef[p]`` when the state carries them with the leading pod axis,
    else zeros."""
    pods = []
    for p, dev in enumerate(mesh.devices):
        copy = lambda t: t.to(dev, copy=True)  # noqa: E731
        ef = (tree_map(lambda e: e[p].to(dev, copy=True), state.ef)
              if state.ef is not None else
              compress_lib.init_error_feedback(tree_map(copy, state.params)))
        pods.append(TrainState(params=tree_map(copy, state.params),
                               opt=tree_map(copy, state.opt),
                               step=copy(state.step), ef=ef))
    return tuple(pods)


def _pmean(values, device):
    """``jax.lax.pmean`` of one value a pod, on ``device``."""
    total = None
    for v in values:
        total = v.to(device) if total is None else total + v.to(device)
    return torch.div(total, total.new_tensor(float(len(values))))


def _send(g, ef) -> tuple:
    """One pod's gradient leaf as it crosses to the other pods: its int8
    blocks and scales, with its new EF residual, shape and dtype kept
    here."""
    q, scale, _, new_ef = compress_lib.quantize_with_feedback(g, ef)
    return q, scale, new_ef, tuple(g.shape), g.dtype


def make_compressed_crosspod_step(loss_fn, schedule, mesh,
                                  opt_cfg=adamw_lib.AdamWConfig(),
                                  accum_steps: int = 1):
    """Cross-pod compressed step over ``mesh``'s ``"pod"`` axis:
    ``(pods, batch) -> (pods, metrics)`` with ``pods`` from
    :func:`podify_state`.  The batch's leading axis is split evenly over
    the pods (the reference's ``P("pod", None)``); each pod takes its
    gradients with accumulation, adds its EF residual and quantizes to
    int8 blocks; every pod then averages all pods' dequantized blocks
    (``sum(q * s) / n_pods``) and applies AdamW to its own copy.  Loss and
    metrics are pod means, on the first pod's device."""
    if tuple(mesh.axis_names) != ("pod",):
        raise ValueError(f"a cross-pod step needs a ('pod',) mesh, got "
                         f"axes {mesh.axis_names}")
    devices = mesh.devices
    n = len(devices)
    grads_of = make_grad_fn(loss_fn, accum_steps)

    def step_fn(pods, batch):
        if len(pods) != n:
            raise ValueError(f"{len(pods)} pod states for a mesh of {n}")
        parts = []
        for k, v in batch.items():
            v = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            if v.shape[0] % n:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows for "
                                 f"{n} pods")
            parts.append((k, v.reshape((n, v.shape[0] // n)
                                       + tuple(v.shape[1:]))))
        losses, sent = [], []
        for p, st in enumerate(pods):
            loss, grads = grads_of(st.params, _on(
                {k: v[p] for k, v in parts}, devices[p]))
            losses.append(loss)
            sent.append(tree_map(_send, grads, st.ef))
            del grads
        out, grad_norms, lrs = [], [], []
        for p, st in enumerate(pods):
            g_hat = tree_map(
                lambda *c: compress_lib.gather_mean(
                    [x[0] for x in c], [x[1] for x in c], devices[p],
                    c[p][3], c[p][4]), *sent)
            lrs.append(schedule(st.step))
            new_params, new_opt, m = adamw_lib.apply_adamw(
                st.params, g_hat, st.opt, lrs[p], opt_cfg)
            grad_norms.append(m["grad_norm"])
            out.append(TrainState(params=new_params, opt=new_opt,
                                  step=st.step + 1,
                                  ef=tree_map(lambda c: c[2], sent[p])))
        # Loss and the optimizer's metrics are pod means, as the
        # reference's pmean; lr and step are the first pod's.
        dev = devices[0]
        metrics = {"loss": _pmean(losses, dev), "lr": lrs[0],
                   "grad_norm": _pmean(grad_norms, dev),
                   "step": pods[0].step.to(torch.float32)}
        return tuple(out), metrics

    return step_fn

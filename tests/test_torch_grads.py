"""The port's ``LM.loss`` and its gradients against the JAX package's, on
the CPU, for all ten architectures; and the port's remat policies against
each other.

Smoke configs in float32, the reference's ``LM.init`` parameters carried
with ``params_from_arrays``, the same tokens (2 x 16 from a numpy seed) and,
for seamless_m4t_medium, the same frames, through ``jax.value_and_grad(
lm.loss)`` and the port's ``runtime.train.value_and_grad(lm.loss)``.
Tolerances, stated once:

  * the loss within 1e-5 relative and each gradient leaf within 1e-4 of its
    max |value| plus 1e-7: two float32 libraries summing in their own
    orders (the forward agrees to about 1e-7, the gradients to about 3e-5
    of their scale for mamba2's SSD and under 6e-6 for the rest);
  * the remat policies (``"none"``, ``"dots"``, ``"full"``) within 1e-6: the
    same operations, recomputed.

Each test runs in a child pytest process (``test_torch_isolation.in_child``)
and imports the port inside, so the test worker never loads torch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models.model import LM as JLM

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-7
REMAT_TOL = 1e-6


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _batch(cfg, seed=0):
    """Tokens (2, 16) and, for an encoder-decoder, frames (2, F, d)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = np.random.default_rng(seed + 100).normal(
            size=(2, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _port(arch, jparams, **replace):
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import params_from_arrays
    from repro_torch.models.model import LM
    cfg = dataclasses.replace(get_smoke_config(arch), **replace)
    return (LM(cfg, param_dtype=torch.float32),
            params_from_arrays(_np_tree(jparams), "cpu"))


@pytest.mark.parametrize("arch", ARCH_IDS)
@in_child
def test_loss_and_grads_equal_reference(arch):
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.train import value_and_grad
    jlm = JLM(j_get_smoke_config(arch), param_dtype=jnp.float32)
    jparams = jlm.init(jax.random.PRNGKey(0))
    batch = _batch(jlm.cfg)
    jloss, jgrads = jax.value_and_grad(jlm.loss)(
        jparams, jax.tree.map(jnp.asarray, batch))
    tlm, tparams = _port(arch, jparams)
    tloss, tgrads = value_and_grad(tlm.loss, tparams, batch)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    got, want = tree_leaves(tgrads), jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for t, j in zip(got, want):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=GRAD_RTOL * np.abs(j).max()
                                   + GRAD_ATOL)


@pytest.mark.parametrize("arch", ["granite_3_2b", "grok1_314b",
                                  "mamba2_2_7b", "hymba_1_5b",
                                  "seamless_m4t_medium"])
@in_child
def test_remat_policies_agree(arch):
    """``remat`` "none", "dots" and "full": equal losses and gradients, and
    a decoder layer under "dots" keeps its products with no batch dimension
    (``aten.mm``) and recomputes everything else."""
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.train import value_and_grad
    jparams = JLM(j_get_smoke_config(arch),
                  param_dtype=jnp.float32).init(jax.random.PRNGKey(0))
    batch = _batch(j_get_smoke_config(arch))
    out = {}
    for remat in ("none", "dots", "full"):
        tlm, tparams = _port(arch, jparams, remat=remat)
        out[remat] = value_and_grad(tlm.loss, tparams, batch)
    loss0, grads0 = out["none"]
    for remat in ("dots", "full"):
        loss, grads = out[remat]
        assert abs(float(loss) - float(loss0)) <= REMAT_TOL
        for a, b in zip(tree_leaves(grads), tree_leaves(grads0)):
            torch.testing.assert_close(a, b, rtol=0, atol=REMAT_TOL)
    P = torch.utils.checkpoint.CheckpointPolicy
    policy = model_lib._dots_policy
    assert policy(None, torch.ops.aten.mm.default) == P.MUST_SAVE
    assert policy(None, torch.ops.aten.addmm.default) == P.MUST_SAVE
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.exp.default,
               torch.ops.aten.mul.Tensor):
        assert policy(None, op) == P.PREFER_RECOMPUTE


@in_child
def test_layer_loop_unbinds_each_stacked_leaf_once():
    """The layer loop takes the stacked leaves apart with one ``unbind`` a
    leaf, so backward stacks each leaf's layer gradients once instead of
    adding a zero tensor of the whole stack per layer."""
    from repro_torch.optim.adamw import tree_leaves
    jparams = JLM(j_get_smoke_config("granite_3_2b"),
                  param_dtype=jnp.float32).init(jax.random.PRNGKey(0))
    tlm, tparams = _port("granite_3_2b", jparams)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    loss = tlm.loss(tparams, _batch(tlm.cfg))
    on_leaf = []     # the nodes whose gradient goes to a param leaf

    def walk(fn, seen):
        if fn is None or fn in seen:
            return
        seen.add(fn)
        if any(type(nxt).__name__ == "AccumulateGrad"
               for nxt, _ in fn.next_functions):
            on_leaf.append(type(fn).__name__)
        for nxt, _ in fn.next_functions:
            walk(nxt, seen)
    walk(loss.grad_fn, set())
    assert sorted(on_leaf).count("UnbindBackward0") == len(tparams["layers"])
    assert "SelectBackward0" not in on_leaf
    assert all(p.grad is None for p in leaves)

"""The port's sharding rules, ``moment_specs``, meshes, placements and the
elastic restore, on the CPU.

``repro_torch.parallel.sharding`` is held to the JAX package's
``parallel/sharding.py``: every resolved spec equals ``tuple()`` of the
reference's ``PartitionSpec`` and the recorded fallbacks are the same,
over a ``jax.sharding.AbstractMesh`` of the same axes on the reference
side (no devices, no subprocess).  The cases are those of
``tests/test_data_and_sharding.py``'s two resolver tests, then every
config's ``param_specs()``, ``cache_specs()`` and ``moment_specs`` on
both production meshes under both profiles.  The port's shapes come from
``LM.init`` and ``init_cache`` over fake tensors, the reference's from
``jax.eval_shape``.  Placements cut and put back tensors over a
``("cpu",) * 4`` (2, 2) mesh, and an elastic restore's shards put back
equal, bit for bit, to a plain restore.

Each test runs in a child pytest process (``test_torch_isolation.in_child``)
and imports the port inside, so the test worker never loads torch.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from test_torch_isolation import in_child

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as j_get_config
from repro.launch.mesh import data_axes as j_data_axes
from repro.models.model import LM as JLM
from repro.optim.adamw import moment_specs as j_moment_specs
from repro.parallel.sharding import make_rules as j_make_rules

PROD = {"single": ((16, 16), ("data", "model")),
        "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(sizes, names):
    from repro_torch.launch.mesh import AbstractMesh
    return JAbstractMesh(sizes, names), AbstractMesh(names, sizes)


@in_child
def test_resolver_cases_of_the_reference_tests():
    """``test_sharding_resolver_no_mesh_is_noop`` and
    ``test_sharding_resolver_divisibility_and_used_axes``'s cases: specs,
    fallbacks and ``moment_specs`` equal the reference's."""
    from repro_torch.optim.adamw import moment_specs
    from repro_torch.parallel.sharding import make_rules
    import torch
    cases = [("base", ("batch", "seq", "embed"), (8, 16, 32)),
             ("base", ("batch", "seq", "heads"), (8, 16, 8)),
             ("base", ("batch", "seq", "heads"), (8, 16, 25)),
             ("base", ("heads", "ff"), (8, 8)),
             ("fsdp", (None, "embed", "ff"), (2, 64, 32)),
             ("fsdp_sp", ("batch", "seq", "embed"), (8, 16, 32))]
    for mesh in (None, (4, 4)):
        jm, tm = (None, None) if mesh is None else _meshes(
            mesh, ("data", "model"))
        for profile, axes, shape in cases:
            jr, tr = j_make_rules(profile, jm), make_rules(profile, tm)
            assert tr.spec(axes, shape) == tuple(jr.spec(axes, shape))
            assert tr.spec(axes) == tuple(jr.spec(axes))
            assert tr.fallbacks == jr.fallbacks
            assert (tr.sharding(axes, shape) is None) == (mesh is None)
    jm, tm = _meshes((4, 4), ("data", "model"))
    jr, tr = j_make_rules("base", jm), make_rules("base", tm)
    specs = {"w": ("embed", "heads"), "b": ("heads",)}
    jshapes = {"w": jax.ShapeDtypeStruct((64, 8), np.float32),
               "b": jax.ShapeDtypeStruct((6,), np.float32)}
    tshapes = {"w": torch.Size((64, 8)), "b": torch.empty(6)}
    assert moment_specs(specs, tshapes, 4, tr) == \
        j_moment_specs(specs, jshapes, 4, jr) == \
        {"w": ("moments", "heads"), "b": ("heads",)}
    assert moment_specs(specs, tshapes, 4) == j_moment_specs(specs, jshapes,
                                                             4)
    sp = make_rules("base_sp", tm, seq_parallel_kv=True)
    jsp = j_make_rules("base_sp", jm, seq_parallel_kv=True)
    assert sp.rules == jsp.rules


def _walk(specs, shapes, prefix=""):
    for k in specs:
        if isinstance(specs[k], dict):
            yield from _walk(specs[k], shapes[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tuple(specs[k]), tuple(shapes[k].shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
@in_child
def test_param_cache_and_moment_specs_resolve_as_the_reference(arch):
    """Every param and cache leaf of the full config, on both production
    meshes under ``base`` and ``fsdp``: the same spec, the same fallbacks,
    and the same ``moment_specs``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import moment_specs
    from repro_torch.parallel.sharding import make_rules
    jlm = JLM(j_get_config(arch))
    jshapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    jspecs = jlm.param_specs()
    seq, batch, _ = SHAPES["decode_32k"]
    jcache = jax.eval_shape(lambda: jlm.init_cache(batch, seq))
    tlm = LM(get_config(arch))
    tspecs = tlm.param_specs()
    with FakeTensorMode():
        tshapes = tlm.init(torch.Generator(), device="cpu")
        tcache = tlm.init_cache(batch, seq, "cpu")
    assert tspecs == jspecs
    assert tlm.cache_specs() == jlm.cache_specs()
    jleaves = list(_walk(jspecs, jshapes))
    assert list(_walk(tspecs, tshapes)) == jleaves
    cspecs = jlm.cache_specs()
    cache = [(k, tuple(cspecs[k]), tuple(tcache[k].shape))
             for k in cspecs if k != "pos"]
    assert cache == [(k, tuple(cspecs[k]), tuple(jcache[k].shape))
                     for k in cspecs if k != "pos"]
    for sizes, names in PROD.values():
        jm, tm = _meshes(sizes, names)
        for profile in ("base", "fsdp"):
            jr, tr = j_make_rules(profile, jm), make_rules(profile, tm)
            for name, axes, shape in jleaves + cache:
                assert tr.spec(axes, shape) == tuple(jr.spec(axes, shape)), \
                    (profile, names, name)
            assert tr.fallbacks == jr.fallbacks
            assert moment_specs(tspecs, tshapes, tm.shape["data"], tr) == \
                j_moment_specs(jspecs, jshapes, jm.shape["data"], jr)
            assert tr.fallbacks == jr.fallbacks


@in_child
def test_production_meshes_and_data_axes():
    """``make_production_mesh`` and ``data_axes`` against the reference's
    (whose production mesh needs 256 devices: its shape stands in)."""
    from repro_torch.launch.mesh import (AbstractMesh, DecodeMesh, data_axes,
                                         make_production_mesh)
    for multi, (sizes, names) in ((False, PROD["single"]),
                                  (True, PROD["multi"])):
        m = make_production_mesh(multi_pod=multi)
        assert isinstance(m, AbstractMesh) and m.devices is None
        jm = JAbstractMesh(sizes, names)
        assert m.shape == dict(jm.shape) and m.axis_names == names
        assert data_axes(m) == j_data_axes(jm)
        d = make_production_mesh(multi_pod=multi,
                                 devices=("cpu",) * int(np.prod(sizes)))
        assert isinstance(d, DecodeMesh) and d.shape == m.shape
    with pytest.raises(ValueError):
        make_production_mesh(devices=("cpu",) * 4)
    assert data_axes(AbstractMesh(("model",), (4,))) == ()


@in_child
def test_placement_cuts_and_puts_back():
    """A (2, 2) ``("cpu",) * 4`` mesh: each shard is the block its entry's
    coordinates name (replicas over an axis the spec leaves out), and
    ``gather`` puts the tensor back."""
    import torch
    from repro_torch.launch.mesh import Placement, make_smoke_mesh
    mesh = make_smoke_mesh(4, 2, devices=("cpu",) * 4)
    t = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    cases = {("data", "model", None): [(0, 0), (0, 1), (1, 0), (1, 1)],
             (None, "model", None): [(0, 0), (0, 1), (0, 0), (0, 1)],
             (None, ("model", "data"), None): [(0, 0), (0, 2), (0, 1),
                                               (0, 3)],
             (None, None, None): [(0, 0)] * 4}
    for spec, blocks in cases.items():
        p = Placement(mesh, spec)
        shards = p.shard(t)
        assert len(shards) == 4
        for s, (i, j) in zip(shards, blocks):
            rows = 4 if spec[0] is None else 2
            cols = 8 if spec[1] is None else 8 // (
                2 if isinstance(spec[1], str) else 4)
            assert torch.equal(s, t[i * rows:(i + 1) * rows,
                                    j * cols:(j + 1) * cols])
        assert torch.equal(p.gather(shards), t)
    with pytest.raises(ValueError):
        Placement(mesh, ("pod", None, None))
    with pytest.raises(ValueError):
        Placement(mesh, (None, None, "model")).shard(t)


@in_child
def test_elastic_restore_puts_back_bit_equal(tmp_path):
    """A Recoil checkpoint of a smoke model, restored with ``shardings``
    from ``make_rules`` over a (2, 2) ``("cpu",) * 4`` mesh: every named
    leaf comes back as its four shards, each on the CPU, which put back
    bit-equal to the plain restore; an unnamed leaf stays whole; with
    ``shardings=None`` the restore is the plain one."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import Placement, make_smoke_mesh
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel.sharding import make_rules
    cfg = get_smoke_config("qwen3_4b")
    lm = LM(cfg, param_dtype=torch.bfloat16)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init(gen, device="cpu")
    mgr = CheckpointManager(root=str(tmp_path), codec="recoil",
                            recoil_splits=64, device="cpu")
    mgr.save(1, {"params": params})
    plain, _ = mgr.restore(n_threads=8)
    mesh = make_smoke_mesh(4, 2, devices=("cpu",) * 4)
    rules = make_rules(cfg.sharding_profile, mesh)
    sh = tree_map(lambda axes, p: rules.sharding(axes, tuple(p.shape)),
                  lm.param_specs(), params)
    del sh["final_norm"]
    placed, step = mgr.restore(n_threads=8, shardings={"params": sh})
    assert step == 1
    assert torch.is_tensor(placed["params"]["final_norm"])
    assert torch.equal(placed["params"]["final_norm"],
                       plain["params"]["final_norm"])
    n_split = 0
    for k, p in sh["layers"].items():
        shards = placed["params"]["layers"][k]
        assert isinstance(p, Placement) and len(shards) == 4
        assert all(s.device.type == "cpu" for s in shards)
        n_split += any(e is not None for e in p.spec)
        back = p.gather(shards)
        ref = plain["params"]["layers"][k]
        assert back.dtype == ref.dtype == torch.bfloat16
        assert torch.equal(back.view(torch.int16), ref.view(torch.int16)), k
    assert n_split >= 4
    again, _ = mgr.restore(n_threads=8, shardings=None)
    for k, v in plain["params"]["layers"].items():
        assert torch.equal(again["params"]["layers"][k], v)

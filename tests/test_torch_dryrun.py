"""The port's dry run and roofline, on the CPU.

``repro_torch.launch.dryrun``'s arithmetic (``effective_accum``,
``model_flops``, ``input_specs``' shapes, dtypes and specs) equals the JAX
package's for every arch x shape x production mesh, with the reference's
rules over a ``jax.sharding.AbstractMesh``.  Then the port's own dry run:
a smoke config's train, prefill and decode rows carry the reference's keys
and positive terms, the L = 2, 3 secant matches a full-depth fake step, the
one-card granite_3_2b ``train_4k`` cell reads no collective bytes, and the
roofline's constants are the H100's.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` (512 host devices)
when it is imported; the tests import it only after jax's backend has
started, and put the variable back, so nothing else sees it.

Each test runs in a child pytest process (``test_torch_isolation.in_child``)
and imports the port inside, so the test worker never loads torch.
"""

import dataclasses
import importlib
import os

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from test_torch_isolation import in_child

from repro.configs import ARCH_IDS, SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import roofline as j_roofline
from repro.parallel.sharding import make_rules as j_make_rules

PROD = {"single": ((16, 16), ("data", "model")),
        "multi": ((2, 16, 16), ("pod", "data", "model"))}
# The keys the reference's run_cell adds to Roofline.row() (dryrun.py).
RUN_CELL_KEYS = ("status", "accum", "lower_s", "compile_s", "cost_pass_s",
                 "mem_detail", "real_pass_collectives", "fallbacks")


def _reference_dryrun():
    jax.devices()    # the backend starts before the module sets XLA_FLAGS
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.mark.parametrize("arch", ARCH_IDS)
@in_child
def test_cell_arithmetic_matches_reference(arch):
    """Every shape on both production meshes: the same micro-batch count,
    model FLOPs, and inputs (shapes, dtypes and resolved specs)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.sharding import make_rules
    jd = _reference_dryrun()
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for name, (sizes, axes) in PROD.items():
        tm = make_production_mesh(multi_pod=name == "multi")
        jm = JAbstractMesh(sizes, axes)
        jr = j_make_rules(jcfg.sharding_profile, jm)
        tr = make_rules(tcfg.sharding_profile, tm)
        dp = tm.shape.get("pod", 1) * tm.shape["data"]
        for shape, (_, gb, _) in SHAPES.items():
            assert dryrun.effective_accum(tcfg, gb, dp) == \
                jd.effective_accum(jcfg, gb, dp)
            assert dryrun.model_flops(tcfg, shape) == \
                jd.model_flops(jcfg, shape)
            for override in (0, 8):
                t_in = dryrun.input_specs(tcfg, shape, tr, override)
                j_in = jd.input_specs(jcfg, shape, jr, override)
                assert list(t_in) == list(j_in)
                for k, j in j_in.items():
                    t = t_in[k]
                    assert tuple(t.shape) == j.shape
                    assert str(t.dtype).split(".")[-1] == str(j.dtype)
                    assert t.spec == tuple(j.sharding.spec)
            assert tr.fallbacks == jr.fallbacks


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@in_child
def test_smoke_config_rows(shape, tmp_path):
    """A smoke config's cell on the 16 x 16 mesh: the reference's row keys,
    positive FLOPs, bytes, time and memory terms, and its JSON written."""
    import json
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    ref = j_roofline.build("a", shape, "single", 256, {}, "", 1.0, 1.0)
    row = dryrun.run_cell("qwen3_4b", shape, "single", str(tmp_path),
                          verbose=False, cfg=get_smoke_config("qwen3_4b"))
    assert set(ref.row()) | set(RUN_CELL_KEYS) <= set(row)
    assert set(row["coll_detail"]) == set(ref.row()["coll_detail"])
    assert row["status"] == "OK" and row["chips"] == 256
    for k in ("hlo_flops_per_dev", "hlo_bytes_per_dev", "model_flops",
              "t_comp_s", "t_mem_s", "mem_per_dev_gb", "useful_ratio"):
        assert row[k] > 0, k
    assert row["mem_detail"]["params"] > 0
    assert row["mem_detail"]["activations"] > 0
    with open(tmp_path / "single" / f"qwen3_4b__{shape}.json") as f:
        assert json.load(f)["status"] == "OK"


@in_child
def test_secant_matches_a_full_depth_fake_step():
    """The L = 2, 3 secant extrapolated to 6 layers against a fake step of
    all 6: FLOPs and bytes equal (every layer is the same work), the
    activation peak within 5% (a train step, the forward's saved
    activations)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.sharding import make_rules
    for arch, shape in (("qwen3_4b", "train_4k"), ("mamba2_2_7b",
                                                   "prefill_32k")):
        cfg = dataclasses.replace(get_smoke_config(arch), n_layers=6,
                                  train_accum=1)
        rules = make_rules(cfg.sharding_profile, make_production_mesh())
        est = dryrun.cost_pass(cfg, shape, rules, accum=1)
        full = dryrun.fake_pass(cfg, shape, est["rows"])
        assert est["flops"] == pytest.approx(full["flops"], rel=1e-9)
        assert est["bytes"] == pytest.approx(full["bytes"], rel=1e-9)
        assert est["activations"] == pytest.approx(full["activations"],
                                                   rel=0.05)


@in_child
def test_one_card_granite_cell_reads_no_collectives(tmp_path):
    """granite_3_2b ``train_4k`` on one card at 8 micro-batches of one
    4096-token sequence (``chip_smoke.py`` phase 11's cell): no collective
    bytes, the whole state on the card, and the step's FLOPs above
    6 N tokens (the recompute of ``remat="dots"``)."""
    from repro_torch.launch import dryrun
    row = dryrun.run_cell("granite_3_2b", "train_4k", "card", str(tmp_path),
                          verbose=False, accum_override=8, batch_override=8)
    assert row["chips"] == 1 and row["accum"] == 8
    assert row["rows_per_pass"] == 1
    assert row["coll_bytes_per_dev"] == 0 and row["t_coll_s"] == 0
    assert row["coll_detail"]["count"] == 0
    assert row["hlo_flops_per_dev"] > row["model_flops"]
    n = 2_534_049_792          # granite's leaves, its vocab padded
    assert row["mem_detail"]["params"] == 2 * n
    assert row["mem_detail"]["moments"] == 8 * n


@in_child
def test_roofline_is_the_h100s():
    """The H100 SXM's constants (the reference's v5e ones replaced),
    ``shape_bytes`` as the reference's, and the collective model's keys."""
    from repro_torch.launch import roofline
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    for s in ("f32[16,128]", "(bf16[2,3], s8[7])", "pred[]", "u4[8]"):
        assert roofline.shape_bytes(s) == j_roofline.shape_bytes(s)
    leaf = roofline.Leaf("w_out", (4, 64, 32), 2, (None, "model", None))
    out = roofline.collective_bytes([leaf], {"data": 2, "model": 2},
                                    kind="train", tokens_per_device=10,
                                    d_model=32)
    assert set(out) == set(j_roofline.collective_bytes(""))
    # the grad all-reduce of the local half, and the forward's partial sums
    assert out["all-reduce"] == 4 * 64 * 32 * 2 / 2 + 4 * 10 * 2 * 32
    assert out["all-gather"] == out["reduce-scatter"] == 0

"""Multi-pod dry run: cost every (arch x shape x mesh) cell with no device.

Counterpart of the JAX package's ``launch/dryrun.py``.  The reference
lowers and compiles each cell's step on 512 forced host devices; torch has
no SPMD compiler to ask, so each cell here runs its step over *fake
tensors* (``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, dtypes
and strides, no storage), and nothing reaches a device:

  * the step is the port's own: ``LM.init``; for ``train`` the loss with
    its backward (``torch.autograd``) and the AdamW update
    (``optim.adamw.apply_adamw``); ``LM.prefill`` for ``prefill``;
    ``LM.decode_step`` on a cache of the cell's length for ``decode``;
  * FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count (the
    products and attention; no elementwise work) and bytes the sum of what
    every dispatched operation reads and writes (views and queries read
    nothing);
  * the step runs on the rows one data-parallel group holds (the global
    batch over ``accum`` micro-batches, over the batch spec's data-axis
    split) at the model's full width, and FLOPs and bytes are divided by
    the ``model`` axis size: the tensor-parallel split of the products and
    their weight reads, taken as even;
  * collective bytes come from ``roofline.collective_bytes``, a model over
    the resolved specs (that function's docstring says what it counts).

Per-device memory (``mem_per_dev_gb``) is state plus temporaries:

  * state from the sharding rules: each leaf's bytes over the product of
    the mesh axes its resolved spec names, for the params, the AdamW
    moments (float32, ``optim.adamw.moment_specs``) and, for ``decode``,
    the cache (``LM.cache_specs``); for ``train`` also the gradients (the
    params' dtype and specs) and, with ``accum > 1``, their float32
    accumulator (the params' specs);
  * activations: the peak of live fake storage the step allocates beyond
    its state (a dispatch mode that follows each storage until it is
    freed), over the forward for ``train`` (the saved activations; the
    backward frees them as the gradients appear, which the state term
    holds) and over the whole step otherwise.  It is taken at the local
    rows and *not* divided over ``model``: an upper bound, since the model
    axis would split the heads' and ff's intermediates too.

Costing: as in the reference, the step is costed at n_layers = 2 and 3 and
extrapolated linearly, total(L) = c2 + (L - 2) * (c3 - c2) (times
``accum`` for FLOPs and bytes).  The reference needed it because XLA's
cost analysis counts a scanned layer once; here every layer is counted, so
the secant is only for speed: the port's layer stack is a Python loop, and
a full-depth fake step of a 64-layer model dispatches every layer's
operations.  ``tests/test_torch_dryrun.py`` holds the secant against a
full-depth fake step.  ``models/scan_util.py::cost_mode`` has no
counterpart: the loop has no scan to unroll.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``--mesh card`` is one H100, a (1, 1) ``("data", "model")`` mesh;
``--batch`` cuts a cell's global batch (``chip_smoke.py`` phase 11 prints
granite's ``train_4k`` at 8 micro-batches of one sequence so).  Rows are
JSON under ``experiments/dryrun/<mesh>/`` (one a cell).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, SHAPES, get_config
from ..models.model import LM
from ..optim import adamw as adamw_lib
from ..optim.adamw import tree_leaves, tree_unflatten
from ..parallel.sharding import make_rules
from . import roofline as roofline_lib
from .mesh import AbstractMesh, make_production_mesh

MESHES = {
    "single": lambda: make_production_mesh(),
    "multi": lambda: make_production_mesh(multi_pod=True),
    "card": lambda: AbstractMesh(("data", "model"), (1, 1)),
}

InputSpec = collections.namedtuple("InputSpec", "shape dtype spec")


def effective_accum(cfg, global_batch: int, dp: int) -> int:
    """Largest a <= cfg.train_accum with (global_batch/a) divisible by dp."""
    per_dp = global_batch // dp
    a = min(cfg.train_accum, per_dp) or 1
    while per_dp % a:
        a -= 1
    return max(a, 1)


def input_specs(cfg, shape_name: str, rules, batch_override: int = 0):
    """Shape, dtype and resolved spec of every model input of a shape cell
    (the reference's ``ShapeDtypeStruct`` stand-ins)."""
    seq, global_batch, kind = SHAPES[shape_name]
    if batch_override:
        global_batch = batch_override

    def sds(shape, dtype, axes):
        return InputSpec(shape, dtype, rules.spec(axes, shape))

    if kind in ("train", "prefill"):
        batch = {"tokens": sds((global_batch, seq), torch.int32,
                               ("batch", None))}
        if cfg.is_encdec:
            batch["frames"] = sds(
                (global_batch, cfg.enc_frames, cfg.d_model), torch.bfloat16,
                ("batch", None, None))
        return batch
    return {"tokens": sds((global_batch, 1), torch.int32, ("batch", None))}


def model_flops(cfg, shape_name: str, batch_override: int = 0) -> float:
    seq, gb, kind = SHAPES[shape_name]
    gb = batch_override or gb
    n_active = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n_active * gb * seq
    if kind == "prefill":
        return 2.0 * n_active * gb * seq
    return 2.0 * n_active * gb  # decode: one new token per sequence


def _split(spec, mesh_shape: dict) -> int:
    """Into how many pieces a resolved spec cuts its tensor."""
    return math.prod(roofline_lib._factor(e, mesh_shape) for e in spec)


def _named_leaves(tree, specs, prefix=""):
    """(path, leaf, logical axes) in ``tree_leaves`` order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named_leaves(tree[k], specs[k], f"{prefix}{k}/")
        elif torch.is_tensor(tree[k]):
            yield f"{prefix}{k}", tree[k], tuple(specs[k])


class _Meter(TorchDispatchMode):
    """Bytes every operation that returns a tensor reads and writes (views
    and queries such as ``.device`` touch no data), and the peak of live
    storage allocated under the mode (storages alive on entry are state,
    never counted): a storage counts from the operation that first returns
    it until it is freed, which a weak reference to it reports."""

    def __init__(self, state=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._state = {t.untyped_storage()._cdata for t in state}
        self._sizes: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in pytree.tree_leaves(out) if torch.is_tensor(t)]
        if outs and not func.is_view:     # not a view or a query
            ins = [t for t in pytree.tree_leaves((args, kwargs))
                   if torch.is_tensor(t)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._state or key in self._sizes:
                continue
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out

    def _free(self, key):
        self.live -= self._sizes.pop(key, 0)


def _fake_inputs(cfg, rows: int, seq: int, kind: str, device):
    tokens = torch.zeros((rows, seq if kind != "decode" else 1),
                         dtype=torch.int32, device=device)
    batch = {"tokens": tokens}
    if cfg.is_encdec and kind != "decode":
        batch["frames"] = torch.zeros((rows, cfg.enc_frames, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    return batch


def fake_pass(cfg, shape_name: str, rows: int) -> dict:
    """One step of a cell over fake tensors at ``rows`` sequences: its
    FLOPs, bytes read and written, and activation peak (see the module
    docstring)."""
    seq, _, kind = SHAPES[shape_name]
    dev = torch.device("cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    with FakeTensorMode():
        lm = LM(cfg, param_dtype=torch.bfloat16)
        params = lm.init(gen, device=dev)
        batch = _fake_inputs(cfg, rows, seq, kind, dev)
        state = tree_leaves(params)
        cache = opt = None
        if kind == "decode":
            cache = lm.init_cache(rows, seq, dev)
            state += [v for v in cache.values() if torch.is_tensor(v)]
            cache["pos"] = seq - 1
        elif kind == "train":
            opt = adamw_lib.init_moments(params)
            state += tree_leaves(opt)
        flops = FlopCounterMode(display=False)
        meter = _Meter(state)
        with flops, meter:
            if kind == "train":
                leaves = [p.detach().requires_grad_(True) for p in
                          tree_leaves(params)]
                loss = lm.loss(tree_unflatten(params, leaves), batch)
                act = meter.peak
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                del loss, leaves
                adamw_lib.apply_adamw(params, tree_unflatten(params, grads),
                                      opt, 3e-4, adamw_lib.AdamWConfig(),
                                      inplace=True)
                del grads
            else:
                with torch.no_grad():
                    if kind == "prefill":
                        lm.prefill(params, batch["tokens"],
                                   batch.get("frames"), cache_len=seq)
                    else:
                        lm.decode_step(params, cache, batch["tokens"])
                act = meter.peak
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(meter.bytes), "activations": float(act)}


def _local_rows(rules, rows: int, seq: int, data: tuple) -> int:
    spec = rules.spec(("batch", None), (rows, seq))
    return rows // roofline_lib._factor(spec[0], rules.mesh.shape, data)


def cost_pass(cfg, shape_name: str, rules, accum: int,
              batch_override: int = 0) -> dict:
    """L in {2, 3} -> the step extrapolated to ``cfg.n_layers``: FLOPs and
    bytes (times ``accum``) and the activation peak, at the rows a
    data-parallel group holds (``rows``)."""
    seq, global_batch, kind = SHAPES[shape_name]
    if batch_override:
        global_batch = batch_override
    micro = global_batch // accum if kind == "train" else global_batch
    data = tuple(a for a in ("pod", "data") if a in rules.mesh.shape)
    rows = _local_rows(rules, micro, seq, data)
    results = {}
    for L in (2, 3):
        cfg_l = dataclasses.replace(
            cfg, n_layers=L,
            enc_layers=min(cfg.enc_layers, L) if cfg.enc_layers else 0,
            train_accum=1)
        results[L] = fake_pass(cfg_l, shape_name, rows)
    L = cfg.n_layers
    mult = accum if kind == "train" else 1

    def extr(k, m):
        v2, v3 = results[2][k], results[3][k]
        return m * max(v2 + (L - 2) * (v3 - v2), 0.0)
    return {"flops": extr("flops", mult), "bytes": extr("bytes", mult),
            "activations": extr("activations", 1), "rows": rows}


def state_bytes(cfg, shape_name: str, rules, accum: int,
                batch_override: int = 0):
    """Per-device state from the specs (see the module docstring), the
    parameter leaves for ``collective_bytes``, and the memory terms."""
    seq, global_batch, kind = SHAPES[shape_name]
    if batch_override:
        global_batch = batch_override
    mesh_shape = rules.mesh.shape
    gen = torch.Generator()
    gen.manual_seed(0)
    with FakeTensorMode():
        lm = LM(cfg, param_dtype=torch.bfloat16)
        params = lm.init(gen, device="cpu")
        pspecs = lm.param_specs()
        leaves, detail = [], collections.Counter()
        for name, p, axes in _named_leaves(params, pspecs):
            spec = rules.spec(axes, tuple(p.shape))
            leaves.append(roofline_lib.Leaf(
                name.split("/")[-1], tuple(p.shape), p.element_size(), spec))
            local = p.numel() / _split(spec, mesh_shape)
            detail["params"] += local * p.element_size()
            if kind == "train":
                detail["grads"] += local * p.element_size()
                if accum > 1:
                    detail["accumulator"] += local * 4
        if kind == "train":
            mspecs = adamw_lib.moment_specs(pspecs, params,
                                            mesh_shape["data"], rules)
            for _, p, axes in _named_leaves(params, mspecs):
                spec = rules.spec(axes, tuple(p.shape))
                detail["moments"] += 2 * 4 * p.numel() / _split(spec,
                                                                mesh_shape)
        if kind == "decode":
            cache = lm.init_cache(global_batch, seq, "cpu")
            cspecs = lm.cache_specs()
            for k, v in cache.items():
                if torch.is_tensor(v):
                    spec = rules.spec(tuple(cspecs[k]), tuple(v.shape))
                    detail["cache"] += (v.numel() * v.element_size()
                                        / _split(spec, mesh_shape))
    return leaves, dict(detail)


def run_cell(arch: str, shape_name: str, mesh_name: str = "single",
             out_dir: str = "experiments/dryrun", verbose: bool = True,
             profile_override: str = "", ssm_split_proj: bool = False,
             accum_override: int = 0, banded: bool = False,
             moe_contraction: bool = False, moe_groups: int = 0,
             batch_override: int = 0, cfg=None):
    """One cell's row, written to ``out_dir/<mesh>/<arch>__<shape>.json``;
    ``cfg`` replaces ``get_config(arch)`` (a smoke config in the tests)."""
    cfg = get_config(arch) if cfg is None else cfg
    if profile_override:
        cfg = dataclasses.replace(cfg, sharding_profile=profile_override)
    if ssm_split_proj:
        cfg = dataclasses.replace(cfg, ssm_split_proj=True)
    if accum_override:
        cfg = dataclasses.replace(cfg, train_accum=accum_override)
    if banded:
        cfg = dataclasses.replace(cfg, banded_attention=True)
    if moe_contraction:
        cfg = dataclasses.replace(cfg, moe_contraction_fsdp=True)
    if moe_groups:
        cfg = dataclasses.replace(cfg, moe_group_dispatch=moe_groups)
    seq, global_batch, kind = SHAPES[shape_name]
    if batch_override:
        global_batch = batch_override
    path = os.path.join(out_dir, mesh_name, f"{arch}__{shape_name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not cfg.runs_shape(shape_name):
        row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "SKIP (full attention at 500k; DESIGN.md §6)"}
        with open(path, "w") as f:
            json.dump(row, f, indent=1)
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape_name}: SKIP", flush=True)
        return row
    mesh = MESHES[mesh_name]()
    rules = make_rules(cfg.sharding_profile, mesh)
    dp = mesh.shape.get("pod", 1) * mesh.shape["data"]
    accum = effective_accum(cfg, global_batch, dp) if kind == "train" else 1

    t0 = time.time()
    leaves, mem_detail = state_bytes(cfg, shape_name, rules, accum,
                                     batch_override)
    t_state = time.time() - t0
    cost = cost_pass(cfg, shape_name, rules, accum, batch_override)
    t_cost = time.time() - t0 - t_state
    mem_detail["activations"] = cost["activations"]
    mem_per_dev = sum(mem_detail.values())
    tp = mesh.shape.get("model", 1)
    tokens = cost["rows"] * (seq if kind != "decode" else 1)
    coll_args = dict(kind=kind, tokens_per_device=tokens,
                     d_model=cfg.d_model, top_k=cfg.top_k)
    coll = roofline_lib.collective_bytes(leaves, mesh.shape, passes=accum,
                                         **coll_args)
    one_pass = roofline_lib.collective_bytes(leaves, mesh.shape, passes=1,
                                             **coll_args)
    rl = roofline_lib.build(
        arch=arch, shape=shape_name, mesh_name=mesh_name,
        chips=int(math.prod(mesh.shape.values())),
        cost={"flops": cost["flops"] / tp,
              "bytes accessed": cost["bytes"] / tp},
        coll=coll, model_flops=model_flops(cfg, shape_name, batch_override),
        memory_per_device=mem_per_dev)
    row = rl.row()
    row.update(status="OK", accum=accum, rows_per_pass=cost["rows"],
               lower_s=round(t_state, 1), compile_s=0.0,
               cost_pass_s=round(t_cost, 1), mem_detail=mem_detail,
               real_pass_collectives=one_pass,
               fallbacks=sorted({f"{f[1]}@{f[0]}" for f in rules.fallbacks})[:20])
    with open(path, "w") as f:
        json.dump(row, f, indent=1, default=str)
    if verbose:
        print(f"[{mesh_name}] {arch} x {shape_name}: OK  "
              f"T=(comp {rl.t_comp:.3e}, mem {rl.t_mem:.3e}, "
              f"coll {rl.t_coll:.3e})s  dom={rl.dominant}  "
              f"useful={rl.useful_ratio:.2f}  mem/dev={mem_per_dev/1e9:.2f}GB"
              f"  state={t_state:.0f}s cost={t_cost:.0f}s", flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default)")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "card"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--profile", default="", help="override sharding profile")
    ap.add_argument("--ssm-split-proj", action="store_true",
                    help="TP-clean SSM projections (hillclimb variant)")
    ap.add_argument("--accum", type=int, default=0,
                    help="override train_accum (hillclimb variant)")
    ap.add_argument("--batch", type=int, default=0,
                    help="override the shape's global batch")
    ap.add_argument("--banded", action="store_true",
                    help="banded SWA attention (hillclimb variant)")
    ap.add_argument("--moe-contraction", action="store_true",
                    help="contraction-FSDP expert layout (hillclimb)")
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="hierarchical MoE dispatch groups (hillclimb)")
    args = ap.parse_args(argv)
    archs = (ARCH_IDS if args.all or args.arch == "all"
             else args.arch.split(","))
    shapes = (list(SHAPES) if args.all or args.shape == "all"
              else args.shape.split(","))
    meshes = {"single": ["single"], "multi": ["multi"], "card": ["card"],
              "both": ["single", "multi"]}[args.mesh]
    failures = []
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                path = os.path.join(args.out, mesh_name,
                                    f"{arch}__{shape}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[{mesh_name}] {arch} x {shape}: cached")
                    continue
                try:
                    run_cell(arch, shape, mesh_name, args.out,
                             profile_override=args.profile,
                             ssm_split_proj=args.ssm_split_proj,
                             accum_override=args.accum, banded=args.banded,
                             moe_contraction=args.moe_contraction,
                             moe_groups=args.moe_groups,
                             batch_override=args.batch)
                except Exception as e:  # noqa: BLE001
                    failures.append((mesh_name, arch, shape, repr(e)))
                    print(f"[{mesh_name}] {arch} x {shape}: FAIL {e}",
                          flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()

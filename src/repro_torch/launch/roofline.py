"""Roofline terms of a dry-run cell, for the NVIDIA H100 SXM.

Counterpart of the JAX package's ``launch/roofline.py``.  Three terms per
(arch x shape x mesh), per device:

    T_comp = FLOPs       / 989e12  FLOP/s  (bf16 dense, H100 SXM)
    T_mem  = bytes       / 3.35e12 B/s     (HBM3)
    T_coll = coll_bytes  / 450e9   B/s     (NVLink 4, one direction)

The reference's constants were a TPU v5e's (197e12 FLOP/s, 819e9 B/s HBM,
50e9 B/s a link); these replace them.  NVLink 4 gives an H100 900 GB/s in
all, 450 GB/s each way; the collective term counts the bytes a device
*receives*, so it takes the one-way 450 GB/s.

FLOPs and bytes come from the dry run's step over fake tensors
(``launch.dryrun``): ``torch.utils.flop_counter.FlopCounterMode``'s count
(products and attention; elementwise work is not counted) and the bytes
every dispatched operation reads and writes (no fusion, so an upper bound
on HBM traffic).  The row's keys keep the reference's names
(``hlo_flops_per_dev``, ...), which there named XLA's cost analysis.

Collective bytes have no HLO to parse in torch: :func:`collective_bytes`
is a model of the collectives SPMD partitioning would insert for the
resolved sharding specs, not a parse (its docstring lists what it counts).
As in the reference, ring-algorithm constants (~2x for an all-reduce) are
noted, not folded in.

``MODEL_FLOPS`` = 6*N*D for training (fwd+bwd), 2*N*D forward-only, with
N = active params — the ratio MODEL_FLOPS/FLOPs exposes remat recompute
and MoE dispatch waste.
"""

from __future__ import annotations

import dataclasses
import math
import re

PEAK_FLOPS = 989e12        # bf16 dense FLOP/s, H100 SXM
HBM_BW = 3.35e12           # B/s, H100 SXM HBM3
LINK_BW = 450e9            # B/s, NVLink 4, one direction (900 GB/s in all)

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}


def shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string, incl. tuples: 'f32[16,128]' etc."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _factor(entry, mesh_shape: dict, axes=None) -> int:
    """How many ways a spec entry splits its dimension (over ``axes``
    only, when given)."""
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(mesh_shape[a] for a in names
                     if axes is None or a in axes)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter leaf as the collective model sees it: its name (the
    last key), shape, bytes an element, and resolved spec."""
    name: str
    shape: tuple
    itemsize: int
    spec: tuple


# Leaves that are not the right operand of a product over the activations.
_NOT_PRODUCTS = ("conv_w", "conv_x_w", "conv_bc_w", "meta")


def collective_bytes(leaves, mesh_shape: dict, *, kind: str,
                     tokens_per_device: int, d_model: int, top_k: int = 0,
                     passes: int = 1, act_bytes: int = 2) -> dict:
    """Bytes each device receives a step, per collective kind: a model.

    ``leaves`` are the parameters with their resolved specs; a step runs
    ``passes`` micro-batches of ``tokens_per_device`` tokens each.  Counted:

    * **FSDP all-gather**: a leaf whose spec names a data axis (``pod``,
      ``data``) is gathered over those axes before use, once a forward
      and once more in the backward (train); a device receives its
      model-sharded slice less its own part.
    * **reduce-scatter**: the same leaves' gradients in the backward, the
      same bytes.
    * **gradient all-reduce** over the data axes (train, once a step, after
      accumulation): every leaf not sharded over data, its local bytes.
    * **tensor-parallel all-reduce** over ``model``: a product whose
      contracted dimension is sharded over ``model`` (``wo``, ``w_out``,
      ``ssm_out``, ...) sums partial outputs, tokens x its local output
      width; in the backward, a product whose output dimension is so
      sharded sums the input's gradient, tokens x its local input width.
      Stacked leaves count once a layer; products that share an input
      (``wq``, ``wk``, ``wv``) count each (an upper bound).  ``embed``
      serves as the transposed unembedding.
    * **MoE all-to-all**: where the experts' dimension is sharded, each
      token's ``top_k`` d_model rows go to their experts and come back, a
      layer, less the share that stays on the device.

    Not counted: the partial-softmax all-reduce of an attention over a
    sequence-sharded cache, the loss's all-reduce over a vocab-sharded
    logit row, and collective-permutes (none is modelled).  ``count`` is
    the number of collective operations a step.
    """
    out = dict.fromkeys(KINDS, 0)
    out["count"] = 0
    data = tuple(a for a in ("pod", "data") if a in mesh_shape)
    train = kind == "train"
    fwd_bwd = 2 if train else 1
    model = mesh_shape.get("model", 1)

    def add(k, nbytes, n_ops):
        if nbytes > 0:
            out[k] += nbytes
            out["count"] += n_ops

    for leaf in leaves:
        numel = math.prod(leaf.shape)
        total = math.prod(_factor(e, mesh_shape) for e in leaf.spec)
        dp = math.prod(_factor(e, mesh_shape, data) for e in leaf.spec)
        local = numel * leaf.itemsize / total
        if dp > 1:
            gathered = local * dp - local
            add("all-gather", passes * fwd_bwd * gathered,
                passes * fwd_bwd)
            if train:
                add("reduce-scatter", passes * gathered, passes)
        elif train and math.prod(mesh_shape[a] for a in data) > 1:
            add("all-reduce", local, 1)

        if leaf.name in _NOT_PRODUCTS or len(leaf.shape) < 2 or model == 1:
            continue
        if leaf.name.startswith("moe_"):
            continue
        spec, shape = leaf.spec, leaf.shape
        layers = shape[0] if len(shape) == 3 else 1
        if leaf.name == "embed":           # logits = x @ embed.T
            d_in, d_out = 1, 0
        else:
            d_in, d_out = len(shape) - 2, len(shape) - 1
        in_m = _factor(spec[d_in], mesh_shape, ("model",))
        out_m = _factor(spec[d_out], mesh_shape, ("model",))
        tok = tokens_per_device * act_bytes
        if in_m > 1:
            add("all-reduce",
                passes * layers * tok * shape[d_out] / out_m,
                passes * layers)
        if train and out_m > 1:
            add("all-reduce",
                passes * layers * tok * shape[d_in] / in_m,
                passes * layers)

    experts = [lf for lf in leaves if lf.name == "moe_gate"]
    for leaf in experts:
        e_split = _factor(leaf.spec[1], mesh_shape)
        if e_split > 1 and top_k:
            layers = leaf.shape[0]
            rows = tokens_per_device * top_k * (1 - 1 / e_split)
            add("all-to-all",
                passes * fwd_bwd * layers * 2 * rows * d_model * act_bytes,
                passes * fwd_bwd * layers * 2)
    return out


@dataclasses.dataclass(frozen=True)
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float          # per-device
    hlo_bytes: float          # per-device
    coll_bytes: float         # per-device
    model_flops: float        # whole-step useful FLOPs (all chips)
    t_comp: float
    t_mem: float
    t_coll: float
    coll_detail: dict
    memory_per_device: float  # bytes (state + temporaries)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_comp, "memory": self.t_mem,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def step_time_bound(self) -> float:
        return max(self.t_comp, self.t_mem, self.t_coll)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs * chips)."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful FLOPs / (chips * peak * bound_time)."""
        t = self.step_time_bound
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "model_flops": self.model_flops,
            "t_comp_s": self.t_comp, "t_mem_s": self.t_mem,
            "t_coll_s": self.t_coll, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "mem_per_dev_gb": self.memory_per_device / 1e9,
            "coll_detail": self.coll_detail,
        }


def build(arch: str, shape: str, mesh_name: str, chips: int,
          cost: dict, coll: dict, model_flops: float,
          memory_per_device: float) -> Roofline:
    """``cost``: per-device ``flops`` and ``bytes accessed``; ``coll``:
    :func:`collective_bytes`' dict (the reference took HLO text here)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll_total = float(sum(v for k, v in coll.items() if k != "count"))
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, coll_bytes=coll_total,
        model_flops=model_flops,
        t_comp=flops / PEAK_FLOPS,
        t_mem=byts / HBM_BW,
        t_coll=coll_total / LINK_BW,
        coll_detail=coll, memory_per_device=memory_per_device)

"""Logical-axis sharding: one rules table, resolved per tensor per mesh.

Counterpart of the JAX package's ``parallel/sharding.py``.  Every tensor
of the LM is annotated with *logical* axis names ("batch", "heads",
"ff", ...).  A :class:`ShardingRules` maps each logical axis to a priority
list of mesh-axis candidates; the resolver picks the first candidate whose
mesh size divides the dimension, else falls back to replication (recording
the fallback, e.g. hymba's 25 heads on a 16-way model axis, or grok's 8
experts).

Profiles:
  * ``base``  — DP over (pod, data); TP over model for heads/ff/vocab;
                ZeRO-1 moments over (data, model).
  * ``fsdp``  — adds ("model", "data") candidates for big parameter axes so
                100B+ archs (grok, llama4-scout) shard weights over the full
                mesh.

The rules tables are copies of the reference's.  :meth:`ShardingRules.spec`
returns a plain tuple with the entries a ``PartitionSpec`` would hold
(``None``, an axis name, or a tuple of names) and reads only
``mesh.shape``, so it resolves over an
:class:`~repro_torch.launch.mesh.AbstractMesh` as over a device mesh;
:meth:`ShardingRules.sharding` gives a
:class:`~repro_torch.launch.mesh.Placement`.  :func:`shard` is a no-op: the
port's models run eagerly on one device and take no sharding constraint
(``models/model.py``'s docstring).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from ..launch.mesh import Placement


# Mesh-axis candidates per logical axis, in priority order.  `None` entries
# mean "replicate".  Tuples mean sharding over multiple mesh axes jointly.
BASE_RULES: dict[str, tuple] = {
    "batch":    (("pod", "data"), ("data",), None),
    "seq":      (None,),
    # KV caches shard their sequence dim over the model axis (flash-decoding
    # style: GSPMD inserts the partial-softmax all-reduce).  Without this no
    # 32k-context decode cell fits 16 GB/chip.
    "kv_seq":   (("model",), None),
    "embed":    (None,),
    "heads":    (("model",), None),
    "kv_heads": (("model",), None),   # falls back to replicate for GQA<model
    "head_dim": (None,),
    "ff":       (("model",), None),
    "experts":  (("model",), None),
    "expert_ff": (("model",), None),
    "vocab":    (("model",), None),
    "ssm_inner": (("model",), None),
    "ssm_heads": (("model",), None),
    "ssm_state": (None,),
    "conv":     (None,),
    "moments":  (("pod", "data", "model"), ("data", "model"), ("data",), None),
    "frames":   (None,),
}

FSDP_RULES = dict(BASE_RULES)
FSDP_RULES.update({
    "ff":        (("model", "data", "pod"), ("model", "data"), ("model",), None),
    "expert_ff": (("model", "data", "pod"), ("model", "data"), ("model",), None),
    # contraction-FSDP expert layout (hillclimb H1): d over data, ff TP-only
    "embed_fsdp": (("data", "pod"), ("data",), None),
    "expert_ff_tp": (("model",), None),
})
BASE_RULES.update({  # present under base profile too (resolve to safe TP)
    "embed_fsdp": (None,),
    "expert_ff_tp": (("model",), None),
})

SEQ_PARALLEL_RULES = {
    # context parallelism for long decode: KV cache sharded on data
    "kv_seq": (("data",), None),
}


@dataclasses.dataclass
class ShardingRules:
    rules: dict
    mesh: Optional[object] = None
    fallbacks: list = dataclasses.field(default_factory=list)

    def spec(self, logical_axes: tuple, shape: tuple = None) -> tuple:
        """Resolve logical axes -> a PartitionSpec's entries, honoring
        divisibility."""
        assert shape is None or len(shape) == len(logical_axes), \
            f"{logical_axes} vs {shape}"
        out = []
        used = set()
        for d, name in enumerate(logical_axes):
            if name is None:
                out.append(None)
                continue
            cands = self.rules.get(name, (None,))
            chosen = None
            for cand in cands:
                if cand is None:
                    break
                axes = cand if isinstance(cand, tuple) else (cand,)
                if any(a in used for a in axes):
                    continue
                if self.mesh is not None:
                    if any(a not in self.mesh.shape for a in axes):
                        continue
                    size = 1
                    for a in axes:
                        size *= self.mesh.shape[a]
                    if shape is not None and shape[d] % size != 0:
                        self.fallbacks.append((logical_axes, name, cand, shape))
                        continue
                chosen = axes
                break
            if chosen is None:
                out.append(None)
            else:
                used.update(chosen)
                out.append(chosen[0] if len(chosen) == 1 else tuple(chosen))
        return tuple(out)

    def sharding(self, logical_axes: tuple, shape: tuple = None):
        if self.mesh is None:
            return None
        return Placement(self.mesh, self.spec(logical_axes, shape))


class _Ctx(threading.local):
    def __init__(self):
        self.rules: Optional[ShardingRules] = None


_CTX = _Ctx()


class use_rules:
    """Context manager installing the active ShardingRules (or None)."""

    def __init__(self, rules: Optional[ShardingRules]):
        self.rules = rules

    def __enter__(self):
        self.prev = _CTX.rules
        _CTX.rules = self.rules
        return self.rules

    def __exit__(self, *exc):
        _CTX.rules = self.prev


def current_rules() -> Optional[ShardingRules]:
    return _CTX.rules


def shard(x, *logical_axes):
    """Annotate an activation with logical axes: a no-op in the port, whose
    models run eagerly on one device (the reference constrains the value's
    sharding under jit)."""
    return x


def make_rules(profile: str = "base", mesh=None,
               seq_parallel_kv: bool = False) -> ShardingRules:
    """Profiles: "base", "fsdp", and "_sp"-suffixed variants that shard the
    residual-stream sequence dim over model (Megatron-SP: layer-boundary
    activations and remat carries shrink 16x; the used-axes resolver keeps
    q/k/v head-sharded)."""
    seq_sharded = profile.endswith("_sp")
    base = profile.removesuffix("_sp")
    rules = dict(FSDP_RULES if base == "fsdp" else BASE_RULES)
    if seq_sharded:
        rules["seq"] = (("model",), None)
    if seq_parallel_kv:
        rules.update(SEQ_PARALLEL_RULES)
    return ShardingRules(rules=rules, mesh=mesh)

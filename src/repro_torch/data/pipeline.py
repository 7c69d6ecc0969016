"""Data pipeline: deterministic, resumable, host-sharded token batches.

Counterpart of the JAX package's ``data/pipeline.py``.  ``DataConfig``,
``SyntheticCorpus`` and ``ShardedCorpus`` are copies of the reference's;
``RecoilShardStore`` is a fork that codes on a device (``device=``,
default ``"cuda"``, which raises without a card):

  * ``write_shard`` ingests the tokens on an
    :class:`~repro_torch.core.encode.EncoderSession` (the card's encode
    scan and split planner) and packs the wire container; the ``.rcl``
    files are the reference's byte for byte;
  * ``read_shard`` thins the container's split metadata to the reading
    host's ``n_threads`` (``combine_plan``) and decodes on a
    :class:`~repro_torch.core.engine.DecoderSession`.  A file carries no
    emission log, so the session runs the pointer walk.  The tokens come
    back as a host array, as the reference's do.

Sources:
  * ``SyntheticCorpus`` — seeded Zipf token stream (offline container; used
    by examples and the end-to-end train driver),
  * ``RecoilShardStore`` — token shards entropy-coded with the paper's codec
    (16-bit symbols, one Recoil container per shard), decoded at whatever
    split count the reading host requests: one encoded artifact serves
    hosts with any core count, no per-host re-encode.

Determinism/resume: batch t is a pure function of (seed, step, host_slice) —
the pipeline state is just the step counter, so restore = set step.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core import container, recoil
from ..core.encode import EncoderSession
from ..core.engine import DecoderSession
from ..core.rans import RansParams, StaticModel
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


class SyntheticCorpus:
    """Seeded Zipf LM tokens: batch(step) is stateless & host-shardable."""

    def __init__(self, cfg: DataConfig, host_index: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        assert cfg.global_batch % n_hosts == 0
        self.local_batch = cfg.global_batch // n_hosts
        self.host_index = host_index

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.host_index))
        z = rng.zipf(cfg.zipf_a, size=(self.local_batch, cfg.seq_len))
        tokens = np.minimum(z - 1, cfg.vocab - 1).astype(np.int32)
        return {"tokens": tokens}


class RecoilShardStore:
    """Token shards as Recoil containers (16-bit symbols).

    write_shard: encode once at ``max_splits`` parallelism, on ``device``.
    read_shard: decoder-side — thin metadata to ``n_threads`` then decode
    with the walk on ``device``.
    """

    def __init__(self, root: str, params: RansParams | None = None,
                 device="cuda"):
        self.root = root
        self.params = params or RansParams(n_bits=14, ways=32)
        self.device = resolve_device(device)
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.rcl")

    def write_shard(self, name: str, tokens: np.ndarray,
                    max_splits: int = 256) -> dict:
        tokens = np.asarray(tokens, dtype=np.int64).ravel()
        if tokens.max(initial=0) >= (1 << 16):
            raise ValueError("token ids must fit 16-bit symbols")
        alpha = int(tokens.max(initial=0)) + 1
        if alpha > (1 << self.params.n_bits):
            raise ValueError(
                f"alphabet {alpha} exceeds 2^{self.params.n_bits} slots")
        model = StaticModel.from_symbols(tokens, alpha, self.params)
        sess = EncoderSession(model, device=self.device)
        buf, plan = sess.ingest_container(tokens, max_splits)
        tmp = self._path(name) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(buf)
        os.replace(tmp, self._path(name))
        return {"bytes": len(buf), "tokens": len(tokens),
                "splits": plan.n_threads}

    def read_shard(self, name: str, n_threads: int = 0) -> np.ndarray:
        with open(self._path(name), "rb") as f:
            buf = f.read()
        pc = container.parse(buf, self.params)
        plan = pc.plan
        if n_threads and n_threads < plan.n_threads:
            plan = recoil.combine_plan(plan, n_threads)
        sess = DecoderSession(pc.model, device=self.device)
        return sess.decode(plan, pc.stream, pc.final_states).cpu().numpy()


class ShardedCorpus:
    """Batches drawn from RecoilShardStore shards (round-robin, packed)."""

    def __init__(self, store: RecoilShardStore, shard_names: list[str],
                 cfg: DataConfig, n_threads: int = 0,
                 host_index: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.local_batch = cfg.global_batch // n_hosts
        self.host_index = host_index
        self._tokens = np.concatenate(
            [store.read_shard(n, n_threads) for n in shard_names])

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        need = self.local_batch * cfg.seq_len
        start = (step * need * (self.host_index + 1)) % max(
            len(self._tokens) - need, 1)
        flat = self._tokens[start:start + need]
        if len(flat) < need:
            flat = np.pad(flat, (0, need - len(flat)))
        return {"tokens": flat.reshape(self.local_batch,
                                       cfg.seq_len).astype(np.int32)}

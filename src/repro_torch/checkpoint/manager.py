"""Fault-tolerant checkpointing with a Recoil-coded payload option, on the
card's ingest and walk kernels.

Counterpart of the JAX package's ``checkpoint/manager.py``; the files are
the reference's, byte for byte:

    <root>/step_<N>/
        manifest.json     tree structure, shapes, dtypes, crc32 per leaf,
                          codec, step — no device information
        <leaf>.npy        codec="raw" (bf16 leaves stored as float32)
        <leaf>.rcl        codec="recoil": int8 block-quantized + rANS-coded
                          (the paper's container, split metadata at
                          ``recoil_splits``-way parallelism; every restoring
                          host thins it to its own thread count)
        <leaf>.scale.npy  per-block float32 scales of a recoil leaf

A recoil leaf is encoded once on the manager's device: quantized with
torch, its histogram taken with ``torch.bincount``, and ingested by an
:class:`~repro_torch.core.encode.EncoderSession` (the encode-scan kernel
and the split planner on the card).  Only the words, the final states and
the split plan cross to the host, for ``container.pack_recoil``.  A restore
parses the container, thins the plan to ``n_threads``, decodes with a
:class:`~repro_torch.core.engine.DecoderSession` (a container read off disk
carries no emission log, so the session's ``layout="auto"`` runs the
pointer walk), dequantizes on the device and returns tensors there.

One departure: a leaf whose int8 values are all equal (a norm scale of
ones) puts the whole frequency table on one symbol, f = 2^n, which the
container's n-bit table field cannot hold, so the reference's ``save``
raises ``ValueError`` on it.  Here one pseudo-count on the next symbol keeps
f below 2^n; the container stays one that the reference parses and decodes.

Durability: write to ``step_<N>.tmp``, fsync the manifest, atomic
``os.replace``; ``latest()`` only sees renamed directories.  ``save_async``
snapshots the tree into host memory (pinned, for card tensors), as the
reference snapshots off the device, and runs the serialization on a worker
thread, which uploads one leaf at a time to encode it; ``wait()`` joins it
(one outstanding snapshot).  An exception in the worker is raised by the
next ``wait()``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from ..core import container, recoil
from ..core.encode import EncoderSession
from ..core.engine import DecoderSession
from ..core.rans import RansParams, StaticModel
from ..device import resolve_device
from ..optim.compress import BLOCK, dequantize_int8, quantize_int8

ALPHABET = 255          # int8 symbols q + 127 in [0, 254]
RECOIL_MIN_SIZE = 4096  # smaller leaves are stored raw


def _flatten(tree, prefix=""):
    if not isinstance(tree, dict):
        raise TypeError("checkpoint trees must be (nested) dicts of arrays")
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "/"))
        elif v is None:
            continue
        else:
            out[name] = v
    return out


def _unflatten_into(flat: dict):
    tree: dict = {}
    for name, v in flat.items():
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype, as the reference's manifest
    writes it (``"bfloat16"`` for bf16)."""
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _snapshot(tree):
    """A copy of ``tree`` that later writes to its tensors cannot reach, off
    the device as the reference's ``np.asarray`` snapshot is: card tensors
    copied into one pinned host buffer (queued on the current stream; wait
    on an event recorded after them before reading), CPU tensors cloned,
    arrays copied.  Dict keys come in sorted order, as the reference's
    ``jax.tree.map`` snapshot gives them."""
    def leaves(node):     # in the order copy() visits them
        if isinstance(node, dict):
            for k in sorted(node):
                yield from leaves(node[k])
        elif torch.is_tensor(node) and node.device.type == "cuda":
            yield node
    cards = list(leaves(tree))
    sizes = [-(-t.numel() * t.element_size() // 64) * 64 for t in cards]
    buf = (torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=True)
           if cards else None)
    offsets = iter(np.cumsum([0] + sizes[:-1]).tolist())

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(node[k]) for k in sorted(node)}
        if node is None:
            return None
        if not torch.is_tensor(node):
            return np.array(node)
        if node.device.type != "cuda":
            return node.detach().clone()
        off = next(offsets)
        host = buf[off:off + node.numel() * node.element_size()].view(
            node.dtype).view(node.shape)
        return host.copy_(node.detach(), non_blocking=True)
    return copy(tree)


def symbol_model(sym: torch.Tensor, params: RansParams) -> StaticModel:
    """The static model of a leaf's symbols: ``StaticModel.from_symbols``'s
    model, from a ``torch.bincount`` on the symbols' device, with one
    pseudo-count on the next symbol when a single symbol holds all the mass
    (see the module docstring)."""
    counts = torch.bincount(sym.int(), minlength=ALPHABET).cpu().numpy()
    present = np.flatnonzero(counts)
    if len(present) == 1:
        counts[(present[0] + 1) % ALPHABET] += 1
    return StaticModel.from_counts(counts, params)


@dataclasses.dataclass
class CheckpointManager:
    """``device`` is where recoil leaves are encoded and, by default,
    restored: ``"cuda"`` (the card's kernels; raises without a card) unless
    the caller passes ``"cpu"`` (the kernels' plain torch versions)."""

    root: str
    keep: int = 3
    codec: str = "raw"             # raw | recoil
    recoil_splits: int = 256       # encode-once max parallelism
    rans_params: RansParams = dataclasses.field(
        default_factory=lambda: RansParams(n_bits=11, ways=32))
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)
        os.makedirs(self.root, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def latest(self) -> int | None:
        steps = [int(d.split("_")[1]) for d in os.listdir(self.root)
                 if d.startswith("step_") and not d.endswith(".tmp")]
        return max(steps) if steps else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    # ------------------------------------------------------------------
    def _encode_leaf(self, t: torch.Tensor):
        """int8-quantize + Recoil-encode one float leaf on the device."""
        q, scale = quantize_int8(t.to(self._device))
        # q + 127 in [0, 254], as bytes (the uint8 view wraps mod 2^8): the
        # session makes its own int32 grid, so the leaf's symbols stay a
        # quarter of their int32 size while it is ingested.
        sym = q.reshape(-1).view(torch.uint8) + 127
        del q
        model = symbol_model(sym, self.rans_params)
        buf, _ = EncoderSession(model, device=self._device).ingest_container(
            sym, self.recoil_splits)
        return buf, scale.cpu().numpy()

    def _decode_leaf(self, buf: bytes, scale: np.ndarray, shape, dev,
                     n_threads: int = 0) -> torch.Tensor:
        pc = container.parse(buf, self.rans_params)
        plan = pc.plan
        if n_threads and n_threads < plan.n_threads:
            plan = recoil.combine_plan(plan, n_threads)
        sess = DecoderSession(pc.model, device=dev)
        sym = sess.decode(plan, pc.stream, pc.final_states)
        q = (sym - 127).to(torch.int8).reshape(-1, BLOCK)
        del sym
        size = int(np.prod(shape))
        return dequantize_int8(q, torch.from_numpy(scale).to(dev),
                               tuple(shape), size)

    # ------------------------------------------------------------------
    def save(self, step: int, tree) -> str:
        flat = _flatten(tree)
        tmp = self._step_dir(step) + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "codec": self.codec, "leaves": {}}
        for name, leaf in flat.items():
            t = leaf if torch.is_tensor(leaf) else torch.as_tensor(
                np.asarray(leaf))
            fname = name.replace("/", "__")
            dtype = _dtype_name(t)
            use_recoil = (self.codec == "recoil"
                          and dtype in ("float32", "bfloat16")
                          and t.numel() >= RECOIL_MIN_SIZE)
            entry = {"shape": list(t.shape), "dtype": dtype,
                     "codec": "recoil" if use_recoil else "raw"}
            if use_recoil:
                buf, scale = self._encode_leaf(t)
                with open(os.path.join(tmp, fname + ".rcl"), "wb") as f:
                    f.write(buf)
                np.save(os.path.join(tmp, fname + ".scale.npy"), scale)
                entry["crc32"] = zlib.crc32(buf)
                entry["bytes"] = len(buf)
            else:
                if dtype == "bfloat16":
                    t = t.float()
                    entry["stored_as"] = "float32"
                path = os.path.join(tmp, fname + ".npy")
                np.save(path, t.detach().cpu().contiguous().numpy())
                with open(path, "rb") as f:
                    entry["crc32"] = zlib.crc32(f.read())
            manifest["leaves"][name] = entry
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        return final

    def save_async(self, step: int, tree):
        """Snapshot ``tree`` off the device (card tensors into pinned host
        memory) and save it on a worker thread, which uploads one leaf at a
        time to encode it; :meth:`wait` joins it.  The caller may go on
        writing to the tree's tensors at once: the copies are queued ahead
        of its later work on the stream."""
        self.wait()
        snap = _snapshot(tree)
        ready = None
        if self._device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()

        def run():
            try:
                if ready is not None:
                    ready.synchronize()
                    with torch.cuda.device(self._device):
                        self.save(step, snap)
                else:
                    self.save(step, snap)
            except Exception as e:  # raised by the next wait()
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.root)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: int | None = None, n_threads: int = 0,
                device=None, verify: bool = True, shardings=None):
        """Load a checkpoint as tensors on ``device`` (default the
        manager's, ``"cuda"`` unless it was built with ``"cpu"``).
        ``n_threads`` is this host's decode parallelism: the Recoil
        metadata is thinned to it before decoding.  Returns (tree, step).

        Elastic restore: ``shardings`` is a tree of
        :class:`~repro_torch.launch.mesh.Placement` s over the *new* mesh
        (``ShardingRules.sharding``), matching the leaves, or None.  Each
        leaf is decoded once on ``device`` and a placed leaf comes back as
        its shards, the list ``placement.shard(leaf)`` gives (one a mesh
        entry, row-major, each on its entry's device;
        ``placement.gather(shards)`` puts it back); a leaf the tree does not
        name stays whole on ``device``.  jax instead returns one global
        array whose shards live on the mesh's devices; a process of the port
        holds the shards themselves."""
        dev = self._device if device is None else resolve_device(device)
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat_sh = {} if shardings is None else _flatten(shardings)
        flat = {}
        for name, entry in manifest["leaves"].items():
            fname = name.replace("/", "__")
            if entry["codec"] == "recoil":
                with open(os.path.join(d, fname + ".rcl"), "rb") as f:
                    buf = f.read()
                if verify and zlib.crc32(buf) != entry["crc32"]:
                    raise IOError(f"crc mismatch on {name}")
                scale = np.load(os.path.join(d, fname + ".scale.npy"))
                t = self._decode_leaf(buf, scale, entry["shape"], dev,
                                      n_threads)
            else:
                path = os.path.join(d, fname + ".npy")
                if verify:
                    with open(path, "rb") as f:
                        if zlib.crc32(f.read()) != entry["crc32"]:
                            raise IOError(f"crc mismatch on {name}")
                t = torch.from_numpy(np.load(path)).to(dev)
            if entry["dtype"] == "bfloat16":
                t = t.to(torch.bfloat16)
            placement = flat_sh.get(name)
            flat[name] = t if placement is None else placement.shard(t)
            del t
        return _unflatten_into(flat), step

"""Recoil-coded checkpoint distribution across a heterogeneous fleet, on
the PyTorch/CUDA port: ``examples/checkpoint_distribution.py`` through
``repro_torch``, with the same calls, sizes, seeds and prints (DESIGN.md
§3.1 — the paper's technique applied to restore traffic).

Trains a small LM briefly, saves ONE Recoil-coded checkpoint (int8-quantized
+ rANS, split metadata at 256-way parallelism, coded by the card's ingest
kernels), then simulates restoring hosts with different core counts: each
thins the metadata to its own parallelism before decoding with the card's
walk, and training continues losslessly (loss picks up where it left off
within quantization noise).

    PYTHONPATH=src python examples/checkpoint_distribution_torch.py

``main(device="cpu")`` runs the same calls on the kernels' plain versions.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models.model import LM
from repro_torch.optim.adamw import tree_leaves
from repro_torch.optim.schedule import constant
from repro_torch.runtime.train import TrainState, init_state, make_train_step

# The demo's sizes; a test may shrink them.
CONFIG = ArchConfig(name="ckpt_demo", family="dense", n_layers=4,
                    d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                    vocab=8192, remat="none")
SEQ_LEN, BATCH, TRAIN_STEPS = 128, 8, 10


def main(device="cuda"):
    cfg = CONFIG
    lm = LM(cfg, param_dtype=torch.float32)
    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=SEQ_LEN,
                                      global_batch=BATCH))
    step_fn = make_train_step(lm.loss, constant(3e-4))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_state(lm.init(gen, device=device))
    for t in range(TRAIN_STEPS):
        state, m = step_fn(state, {"tokens": data.batch(t)["tokens"]})
    loss_before = float(m["loss"])
    print(f"trained {TRAIN_STEPS} steps, loss {loss_before:.4f} "
          f"({cfg.n_params()/1e6:.1f}M params)")

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(root=d, codec="recoil", recoil_splits=256,
                                device=device)
        t0 = time.time()
        path = mgr.save(TRAIN_STEPS, {"params": state.params,
                                      "opt": state.opt})
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        raw = sum(x.numel() * x.element_size()
                  for x in tree_leaves(state.params))
        raw += sum(x.numel() * x.element_size()
                   for x in tree_leaves(state.opt))
        print(f"checkpoint: {size/1e6:.1f} MB on disk vs {raw/1e6:.1f} MB raw "
              f"({size/raw*100:.0f}%), written in {time.time()-t0:.1f}s, "
              f"metadata at 256-way parallelism")

        for host, threads in [("edge-node", 2), ("trainer", 32),
                              ("big-box", 256)]:
            t0 = time.time()
            tree, _ = mgr.restore(TRAIN_STEPS, n_threads=threads)
            dt = time.time() - t0
            restored = TrainState(params=tree["params"], opt=tree["opt"],
                                  step=torch.tensor(TRAIN_STEPS,
                                                    dtype=torch.int32,
                                                    device=device))
            s2, m2 = step_fn(restored, {"tokens": data.batch(TRAIN_STEPS)[
                "tokens"]})
            print(f"{host:10s} restored with {threads:3d} decode threads "
                  f"in {dt:4.1f}s -> next-step loss {float(m2['loss']):.4f}")
    print("all hosts resumed within int8-quantization noise of each other")


if __name__ == "__main__":
    main()

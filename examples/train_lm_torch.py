"""End-to-end training driver on the PyTorch/CUDA port: ``examples/
train_lm.py`` through ``repro_torch``, with the same presets, calls,
seeds and prints: ~100M-param LM, synthetic corpus, AdamW, grad
accumulation, async Recoil-coded checkpoints, preemption handling,
straggler-aware metrics.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300   # the card
    PYTHONPATH=src python examples/train_lm_torch.py --preset tiny --steps 20 \
        --device cpu

Restores automatically from the newest checkpoint in --ckpt-dir (default
under the temporary directory), so killing and relaunching the process
continues the run (fault-tolerance demo: send SIGTERM mid-run and
relaunch).  ``main(argv, device=...)`` runs the same on a device of the
caller's choice.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models.model import LM
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.runtime.fault import PreemptionGuard, StepTimer
from repro_torch.runtime.metrics import MetricsLogger
from repro_torch.runtime.train import TrainState, init_state, make_train_step

PRESETS = {
    # ~101M params: 12 x (d=640, ff=2560) + 32k vocab tied embeddings
    "100m": dict(cfg=ArchConfig(name="lm100m", family="dense", n_layers=12,
                                d_model=640, n_heads=10, n_kv_heads=10,
                                d_ff=2560, vocab=32_000, remat="none"),
                 seq=256, batch=8, accum=2),
    "tiny": dict(cfg=ArchConfig(name="lmtiny", family="dense", n_layers=2,
                                d_model=64, n_heads=4, n_kv_heads=2,
                                d_ff=128, vocab=512, remat="none"),
                 seq=64, batch=4, accum=1),
}


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="100m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--codec", default="recoil", choices=["raw", "recoil"])
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    p = PRESETS[args.preset]
    cfg = p["cfg"]
    lm = LM(cfg, param_dtype=torch.float32)
    print(f"model: {cfg.name}  params={cfg.n_params()/1e6:.1f}M  "
          f"tokens/step={p['seq']*p['batch']}")

    data = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=p["seq"],
                                      global_batch=p["batch"]))
    step_fn = make_train_step(
        lm.loss, cosine_with_warmup(3e-4, 20, args.steps),
        accum_steps=p["accum"])
    mgr = CheckpointManager(root=args.ckpt_dir, codec=args.codec, keep=2,
                            device=args.device)

    start = 0
    if mgr.latest() is not None:
        tree, start = mgr.restore(n_threads=os.cpu_count())
        state = TrainState(params=tree["params"], opt=tree["opt"],
                           step=torch.tensor(start, dtype=torch.int32,
                                             device=args.device))
        print(f"restored from step {start} "
              f"({args.codec}-coded checkpoint, decoder-adaptive)")
    else:
        gen = torch.Generator(device=args.device)
        gen.manual_seed(0)
        state = init_state(lm.init(gen, device=args.device))

    log = MetricsLogger(print_every=10)
    timer = StepTimer()
    timer.lap_ms()
    with PreemptionGuard() as guard:
        for t in range(start, args.steps):
            batch = {"tokens": data.batch(t)["tokens"]}
            state, m = step_fn(state, batch)
            m = {k: float(v) for k, v in m.items()}
            m["step_ms"] = timer.lap_ms()
            log.log(t, m, tokens_per_step=p["seq"] * p["batch"],
                    model_flops_per_token=6 * cfg.n_params())
            if (t + 1) % args.ckpt_every == 0 or guard.preempted:
                mgr.wait()
                mgr.save_async(t + 1, {"params": state.params,
                                       "opt": state.opt})
            if guard.preempted:
                print(f"preempted at step {t}; checkpoint saved, exiting")
                break
    mgr.wait()
    print("done; final loss:", m["loss"])


if __name__ == "__main__":
    main()

"""Depth sweep of ``chip_smoke.py`` phase 9's holds, on one card.

For each family of phase 9 (or the archs named as arguments): the bf16
decode at 1, 2, 4 and 8 layers (up to its serving depth) and the
float32 decode at its twin's depth and its config's, each held to ``forward`` over the
same tokens as phase 9 holds them (a float32 run also under the planted
cache faults), from the same seeded generator and prompts.  Each run
prints phase 9's line; a difference past the tolerance is printed as
``PAST``, not fatal, since the sweep measures where rounding crosses it.
Run from the repo's root with a card::

    python3 chip_holds.py [arch ...]
"""

import sys
import time

import torch

import chip_smoke as cs

BF16_DEPTHS = (1, 2, 4, 8)
F32_DEPTHS = {"mamba2_2_7b": (4, None), "hymba_1_5b": (4, None),
              "seamless_m4t_medium": (4, None), "grok1_314b": (1,)}


def main(archs) -> int:
    smi = cs.phase_device()
    sys.path.insert(0, cs.SRC)
    from repro_torch.configs import get_config
    cs.fail = lambda msg: cs.log(f"PAST: {msg}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    for arch in archs:
        run = cs.FAMILY_RUNS[arch]
        top = run.depth or get_config(arch).n_layers
        sweep = [(cs.BF16, n, cs.LM_BF16_ATOL) for n in BF16_DEPTHS
                 if n <= top]
        f32 = {n: atol for dt, n, atol in run.holds if dt == cs.F32}
        sweep += [(cs.F32, n, f32.get(n, next(iter(f32.values()))))
                  for n in F32_DEPTHS[arch]]
        for dtype, layers, atol in sweep:
            t = time.perf_counter()
            lm, params, _, _ = cs._family_lm(
                arch, dev, gen, int(dtype == cs.F32), dtype, layers=layers)
            prompt = cs._lm_tokens(lm.cfg.vocab, length=run.prompt)
            cs._serve(lm, params, prompt,
                      f"{arch} {'float32' if dtype == cs.F32 else 'bf16'} "
                      f"sweep, {lm.cfg.n_layers} layers", atol, smi, dev,
                      "[holds]", 1, frames=cs._lm_frames(lm.cfg),
                      hold_lm=cs._hold_lm(lm), faults=dtype == cs.F32)
            del lm, params
            torch.cuda.empty_cache()
            cs.log(f"[holds]   {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(cs.FAMILY_RUNS)))

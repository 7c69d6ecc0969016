"""The bf16 drift of a model cut in depth, in the JAX package and in the port.

Builds one architecture at full width, cut to a number of layers, from the
reference's ``LM.init(PRNGKey(0))`` in bf16, carried bit for bit into the
port (``models/convert.py``).  Two prompts of ``prompt`` tokens (drawn from
``numpy.random.default_rng(seed)``) are prefilled and ``steps`` tokens
decoded; each package's *drift* is its largest |decode logit - its own
``forward`` logit| over those steps, and the *gaps* hold the port's
``forward`` and decode logits against the reference's.  Each package's
prefill logits (the prompt's last position) are held to its own
``forward``'s, and the reference's bf16 ``forward`` to its float32 one on
the same parameters (how far the model amplifies rounding).  Padding columns of
the vocabulary and hymba's meta-token positions are left out.

``--row-products`` runs the port with every ``x @ W`` (a 2-D ``W``)
computed one row at a time.  torch's GEMM sums a row in an order that
depends on how many rows the call has (oneDNN on the CPU), so the forward's
72-row products, the prefill's 64-row ones and a decode step's 2-row ones
round differently; XLA's CPU dot gives a row the same bits in any call.
With rows one at a time the port's products are row-count invariant too,
which isolates that part of the drift (slow; a diagnostic only).

Runs on the CPU with both packages in one process:

    PYTHONPATH=src python tests/torch_drift.py --layers 1,2,4,8

(mamba2_2_7b, about 10 s a depth up to 4 layers and 15 s at 8).
``tests/test_torch_families.py`` holds one row of it.
"""

import argparse
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro.configs import get_config as j_get_config
from repro.models.model import LM as JLM
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_arrays
from repro_torch.models.model import LM


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


class RowProducts(TorchFunctionMode):
    """Every ``x @ W`` with a 2-D ``W``, one row of ``x`` at a time."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (getattr(func, "__name__", "") in ("matmul", "__matmul__")
                and args[1].dim() == 2 and args[0].dim() >= 2):
            x, w = args
            rows = x.reshape(-1, x.shape[-1])
            out = torch.cat([rows[i:i + 1] @ w for i in range(len(rows))])
            return out.reshape(*x.shape[:-1], w.shape[-1])
        return func(*args, **(kwargs or {}))


def drift_row(arch: str, layers: int, *, seed: int = 0, prompt: int = 32,
              steps: int = 4, row_products: bool = False) -> dict:
    """One row of the drift table (see the module docstring)."""
    jcfg = dataclasses.replace(j_get_config(arch), n_layers=layers)
    tcfg = dataclasses.replace(get_config(arch), n_layers=layers)
    jlm = JLM(jcfg, param_dtype=jnp.bfloat16)
    jp = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(tcfg, param_dtype=torch.bfloat16)
    tp = params_from_arrays(_np_tree(jp), "cpu")
    B, V = 2, jcfg.vocab
    toks = np.random.default_rng(seed).integers(
        0, V, (B, prompt + steps)).astype(np.int32)

    meta = jcfg.meta_tokens
    jfull = np.asarray(jlm.forward(jp, toks), np.float32)[:, meta:, :V]
    j32 = JLM(jcfg, param_dtype=jnp.float32).forward(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp), toks)
    j32 = np.asarray(j32, np.float32)[:, meta:, :V]
    jpre, jcache = jax.jit(jlm.prefill)(jp, toks[:, :prompt])
    step = jax.jit(jlm.decode_step)
    jdec = []
    for t in range(steps):
        lg, jcache = step(jp, jcache, toks[:, prompt + t:prompt + t + 1])
        jdec.append(np.asarray(lg, np.float32).reshape(B, -1)[:, :V])
    with torch.no_grad(), (RowProducts() if row_products
                           else contextlib.nullcontext()):
        tfull = tlm.forward(tp, toks).float().numpy()[:, meta:, :V]
        tpre, cache = tlm.prefill(tp, toks[:, :prompt])
        tdec = []
        for t in range(steps):
            lg, cache = tlm.decode_step(
                tp, cache,
                torch.from_numpy(toks[:, prompt + t:prompt + t + 1]))
            tdec.append(lg.float().numpy().reshape(B, -1)[:, :V])
    jdec, tdec = np.stack(jdec, 1), np.stack(tdec, 1)
    jpre = np.asarray(jpre, np.float32).reshape(B, -1)[:, :V]
    tpre = tpre.float().numpy().reshape(B, -1)[:, :V]
    at = slice(prompt, prompt + steps)
    return {
        "layers": layers,
        "ref_drift": float(np.abs(jdec - jfull[:, at]).max()),
        "port_drift": float(np.abs(tdec - tfull[:, at]).max()),
        "forward_gap": float(np.abs(tfull - jfull).max()),
        "decode_gap": float(np.abs(tdec - jdec).max()),
        "ref_prefill": float(np.abs(jpre - jfull[:, prompt - 1]).max()),
        "port_prefill": float(np.abs(tpre - tfull[:, prompt - 1]).max()),
        "ref_bf16_f32": float(np.abs(jfull - j32).max()),
        "magnitude": float(np.abs(jfull).max()),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2_2_7b")
    ap.add_argument("--layers", default="1,2,4,8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--row-products", action="store_true")
    args = ap.parse_args()
    print("| Layers | Reference drift | Port drift | Port forward - "
          "reference forward | Port decode - reference decode | Reference "
          "prefill - forward | Port prefill - forward | Reference bf16 - "
          "float32 forward |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for layers in (int(n) for n in args.layers.split(",")):
        r = drift_row(args.arch, layers, seed=args.seed,
                      row_products=args.row_products)
        print(f"| {layers} | {r['ref_drift']:.4f} | {r['port_drift']:.4f} "
              f"| {r['forward_gap']:.4f} | {r['decode_gap']:.4f} "
              f"| {r['ref_prefill']:.4f} | {r['port_prefill']:.4f} "
              f"| {r['ref_bf16_f32']:.4f} |",
              flush=True)


if __name__ == "__main__":
    main()

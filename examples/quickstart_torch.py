"""Quickstart on the PyTorch/CUDA port: encode once, scale the metadata to
any decoder, decode in parallel — ``examples/quickstart.py`` through
``repro_torch``, at the same size and seed, with the same checks.

    PYTHONPATH=src python examples/quickstart_torch.py    # on the card

``main(device="cpu")`` runs the same calls on the plain torch walks.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import (DecoderSession, RansParams, StaticModel,
                              combine_plan, plan_splits, serialize_plan)
from repro_torch.core.vectorized import encode_interleaved_fast
from repro_torch.kernels.rans_decode import decode_recoil_kernel


def main(device="cuda"):
    # --- data + model: 2 MB of skewed bytes, 11-bit quantized distribution
    rng = np.random.default_rng(0)
    symbols = np.minimum(rng.exponential(30, size=2_000_000).astype(np.int64),
                         255)
    params = RansParams(n_bits=11, ways=32)          # paper Table 3
    model = StaticModel.from_symbols(symbols, 256, params)

    # --- encode ONCE at the server's max supported parallelism -----------
    encoded = encode_interleaved_fast(symbols, model)
    plan = plan_splits(encoded, 2176)            # split metadata, no re-encode
    print(f"stream: {encoded.stream_bytes():,} B   "
          f"metadata@2176: {len(serialize_plan(plan)):,} B")

    # --- serve a 16-core client: combine splits by DELETING metadata -----
    small = combine_plan(plan, 16)
    print(f"metadata@16:   {len(serialize_plan(small)):,} B "
          f"(same bitstream, no re-encode)")

    # --- decode with both plans through the engine, then the kernel ------
    session = DecoderSession(model, device=device)
    walk = "Hopper walk kernel" if session.impl == "cuda" else "plain walk"
    for name, p in [("client@2176", plan), ("client@16", small)]:
        out = session.decode(p, encoded.stream, encoded.final_states)
        assert (out.cpu().numpy() == symbols).all()
        print(f"{name}: engine decode OK ({p.n_threads} threads, {walk})")

    out = decode_recoil_kernel(combine_plan(plan, 64), encoded.stream,
                               encoded.final_states, model, device=device)
    assert (out.cpu().numpy() == symbols).all()
    print(f"client@64: decode_recoil_kernel OK ({walk})")


if __name__ == "__main__":
    main()

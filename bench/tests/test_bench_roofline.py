"""The roofline counts, worked by hand, and read from the cell's inputs
(the benchmark's own parse of a container) only."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import content, reference, roofline


def test_walk_count_by_hand():
    # 1,000 words read (2,000 B), 300 B of metadata and a 356 B table read
    # once, 4,000 byte symbols written once.
    assert roofline.walk_bytes(1000, 300, 356, 4000) == 6656


def test_share_against_the_peak():
    assert roofline.share_pct(3_350_000, 1e-6) == pytest.approx(100.0)
    assert roofline.share_pct(3_350_000, 4e-6) == pytest.approx(25.0)
    assert roofline.share_pct(100, 0.0) is None
    assert roofline.PEAK_BYTES_PER_S == 3.35e12


def test_counts_take_sizes_from_the_container():
    """The walk count of a packed container from the program's packer,
    through the benchmark's own parse: its words, metadata and table."""
    from repro_torch.core import container, recoil
    from repro_torch.core.rans import RansParams, StaticModel, build_cdf
    from repro_torch.core.vectorized import encode_interleaved_fast
    dist = {"kind": "exponential", "scale": 25.5, "clip": 255}
    f = content.quantize(content.pmf(dist), 11).astype(np.uint32)
    model = StaticModel(f=f, F=build_cdf(f), params=RansParams(11, ways=32))
    syms = content.draw(dist, 1, 6000, 3, "cpu")[0].numpy().astype(np.int64)
    enc = encode_interleaved_fast(syms, model)
    buf = container.pack_recoil(enc, model, recoil.plan_splits(enc, 8))
    c = reference.parse_container(buf)
    header = 4 + 20 + 4 * 32
    assert c.size == header + c.table_bytes + c.metadata_bytes + 2 * c.n_words
    assert roofline.walk_bytes(c.n_words, c.metadata_bytes, c.table_bytes,
                               c.n_symbols) == c.size - header + 6000


def test_roofline_reads_nothing_of_the_program():
    tree = ast.parse(Path(roofline.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "subprocess"}


def test_content_is_the_same_for_the_same_seed():
    dist = {"kind": "exponential", "scale": 25.5, "clip": 255}
    a = content.draw(dist, 2, 5000, 2 ** 31 + 99, "cpu")
    b = content.draw(dist, 2, 5000, 2 ** 31 + 99, "cpu")
    c = content.draw(dist, 2, 5000, 2 ** 31 + 100, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    p = content.pmf(dist)
    assert p.sum() == pytest.approx(1.0) and (p > 0).all()
    f = content.quantize(p, 11)
    assert f.sum() == 2048 and f.min() >= 1

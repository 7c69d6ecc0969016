"""The port's copies of the host modules against their originals.

The port keeps its own copy of every jax-free module it needs (rans,
interleaved, heuristic, recoil, bitio, metadata, conventional, container,
adaptive; the runtime's trace, registry, profiler, faultinject and metrics,
and the pipeline's controller and capability registry) and
re-implements the host encoder.  These tests feed the same seeded inputs
to both packages and require equal arrays and equal bytes, parse the
frozen golden containers with the port, hold the runtime copies' source
text equal to the originals', and hold the code of the pipeline's two
forks (broker, predictor) to the originals' apart from listed hunks.

Each test runs in a child pytest process (``test_torch_isolation.in_child``),
and the port is imported inside the tests, so the test worker itself never
loads torch beside jaxlib.
"""

import ast
import difflib
import glob
import io
import os
import tokenize

import numpy as np
import pytest
from test_torch_isolation import in_child

from repro.core import adaptive as j_adaptive
from repro.core import container as j_container
from repro.core import metadata as j_metadata
from repro.core import rans as j_rans
from repro.core import recoil as j_recoil
from repro.core.conventional import encode_conventional as j_encode_conv
from repro.core.vectorized import encode_interleaved_fast as j_encode

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_NAMES = sorted(os.path.splitext(os.path.basename(p))[0]
                      for p in glob.glob(os.path.join(GOLDEN, "*.bin")))


def _symbols(seed, n, alphabet=256, lam=40.0):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.exponential(lam, size=n).astype(np.int64),
                      alphabet - 1)


def _models(syms, alphabet, n_bits, ways):
    from repro_torch.core import rans
    jm = j_rans.StaticModel.from_symbols(
        syms, alphabet, j_rans.RansParams(n_bits=n_bits, ways=ways))
    tm = rans.StaticModel.from_symbols(
        syms, alphabet, rans.RansParams(n_bits=n_bits, ways=ways))
    return jm, tm


def _port_enc(enc):
    """The reference's EncodedStream fields as the port's EncodedStream."""
    from repro_torch.core import rans
    from repro_torch.core.interleaved import EncodedStream
    p = enc.params
    return EncodedStream(stream=enc.stream, final_states=enc.final_states,
                         n_symbols=enc.n_symbols,
                         params=rans.RansParams(n_bits=p.n_bits,
                                                ways=p.ways),
                         k_of_word=enc.k_of_word, y_of_word=enc.y_of_word)


@pytest.mark.parametrize("seed,n_bits,alphabet", [
    (0, 8, 256), (1, 11, 256), (2, 12, 100), (3, 14, 4096), (4, 16, 4096)])
@in_child
def test_tables_equal(seed, n_bits, alphabet):
    from repro_torch.core import rans
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 1000, size=alphabet) * (rng.random(alphabet) > .3)
    counts[0] += 1
    f_j = j_rans.quantize_pdf(counts, n_bits)
    f_t = rans.quantize_pdf(counts, n_bits)
    np.testing.assert_array_equal(f_t, f_j)
    assert f_t.dtype == f_j.dtype
    F = rans.build_cdf(f_t)
    np.testing.assert_array_equal(F, j_rans.build_cdf(f_j))
    np.testing.assert_array_equal(rans.build_slot_lut(f_t, F),
                                  j_rans.build_slot_lut(f_j, F))
    if alphabet <= 256 and n_bits <= 12:
        np.testing.assert_array_equal(rans.pack_decode_lut(f_t, F),
                                      j_rans.pack_decode_lut(f_j, F))


@pytest.mark.parametrize("kind", ["many_small", "zipf_granite", "sparse",
                                  "surplus"])
@in_child
def test_quantize_pdf_equals_reference(kind):
    """The port's ``quantize_pdf`` makes each redistribution pass one vector
    update (the reference loops over the alphabet in Python): the tables
    are the reference's, over cases that take bins away (many symbols
    raised to 1, a Zipf sample over granite_3_2b's 49,155-token vocabulary
    at n = 16) and that add to them (a few large counts)."""
    from repro_torch.core import rans
    rng = np.random.default_rng(7)
    cases = {
        "many_small": [(rng.integers(0, 3, 5000), 13)],
        "zipf_granite": [(np.bincount(np.minimum(
            rng.zipf(1.3, size=1_000_000) - 1, 49_154), minlength=49_155),
            16)],
        "sparse": [(np.where(rng.random(3000) > 0.9,
                             rng.integers(1, 10 ** 6, 3000), 0), n)
                   for n in (11, 12, 16)],
        "surplus": [(np.array([10 ** 6, 3, 0, 10 ** 5, 7]), n)
                    for n in (8, 11, 16)],
    }[kind]
    for counts, n_bits in cases:
        want = j_rans.quantize_pdf(counts, n_bits)
        got = rans.quantize_pdf(counts, n_bits)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,ways,n_bits", [
    (1, 32, 11), (31, 32, 11), (999, 32, 11), (4_096, 8, 8),
    (17_331, 64, 16), (20_000, 128, 12), (5_555, 16, 14)])
@in_child
def test_host_encoder_equals_reference(n, ways, n_bits):
    from repro_torch.core.interleaved import decode_interleaved
    from repro_torch.core.vectorized import encode_interleaved_fast
    syms = _symbols(n, n)
    jm, tm = _models(np.concatenate([syms, np.arange(256)]), 256, n_bits,
                     ways)
    a = j_encode(syms, jm)
    b = encode_interleaved_fast(syms, tm)
    for field in ("stream", "final_states", "k_of_word", "y_of_word"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
        assert getattr(b, field).dtype == getattr(a, field).dtype, field
    assert b.n_symbols == a.n_symbols
    np.testing.assert_array_equal(decode_interleaved(b, tm), syms)


@pytest.mark.parametrize("n,ways,n_splits", [
    (6_000, 32, 16), (4_097, 64, 9), (12_345, 16, 40)])
@in_child
def test_plans_equal(n, ways, n_splits):
    from repro_torch.core import convert, metadata, recoil
    syms = _symbols(n + 1, n)
    jm, tm = _models(syms, 256, 11, ways)
    enc = j_encode(syms, jm)
    jp = j_recoil.plan_splits(enc, n_splits)
    tp = recoil.plan_splits(_port_enc(enc), n_splits)
    for threads in (None, 1, 2, 3, 7, n_splits - 1, n_splits + 5):
        j_thin = jp if threads is None else j_recoil.combine_plan(jp, threads)
        t_thin = tp if threads is None else recoil.combine_plan(tp, threads)
        ja, ta = convert.plan_arrays(j_thin), convert.plan_arrays(t_thin)
        for key in ja:
            np.testing.assert_array_equal(ta[key], ja[key])
        assert metadata.serialize_plan(t_thin) == \
            j_metadata.serialize_plan(j_thin)
    np.testing.assert_array_equal(
        recoil.decode_recoil(tp, enc.stream, enc.final_states, tm), syms)


@in_child
def test_containers_equal():
    from repro_torch.core import container, metadata, recoil
    from repro_torch.core.conventional import encode_conventional
    syms = _symbols(9, 7_000)
    jm, tm = _models(syms, 256, 11, 32)
    enc = j_encode(syms, jm)
    t_enc = _port_enc(enc)
    jp = j_recoil.plan_splits(enc, 12)
    tp = recoil.plan_splits(t_enc, 12)
    assert container.pack_recoil(t_enc, tm, tp) == \
        j_container.pack_recoil(enc, jm, jp)
    assert container.pack_single(t_enc, tm) == j_container.pack_single(enc, jm)
    assert container.pack_recoil_chunked(t_enc, tm, tp, 3) == \
        j_container.pack_recoil_chunked(enc, jm, jp, 3)
    short = syms[:2_000]
    assert container.pack_conventional(encode_conventional(short, tm, 3),
                                       tm) == \
        j_container.pack_conventional(j_encode_conv(short, jm, 3), jm)
    # The reference's wire bytes parse in the port to the same content.
    parsed = container.parse(j_container.pack_recoil(enc, jm, jp),
                             tm.params)
    assert parsed.kind == container.KIND_RECOIL
    np.testing.assert_array_equal(parsed.stream, enc.stream)
    np.testing.assert_array_equal(parsed.final_states, enc.final_states)
    np.testing.assert_array_equal(parsed.model.f, jm.f)
    assert metadata.serialize_plan(parsed.plan) == \
        j_metadata.serialize_plan(jp)


@pytest.mark.parametrize("name", GOLDEN_NAMES)
@in_child
def test_golden_vectors_parse_to_frozen_truth(name):
    from repro_torch.core import container, metadata, rans, recoil
    from repro_torch.core.vectorized import encode_interleaved_fast
    with open(os.path.join(GOLDEN, f"{name}.bin"), "rb") as f:
        buf = f.read()
    npz = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    params = rans.RansParams(n_bits=int(npz["n_bits"]), ways=int(npz["ways"]))
    parsed = container.parse(buf, params)
    ref = j_container.parse(buf, j_rans.RansParams(n_bits=params.n_bits,
                                                   ways=params.ways))
    assert parsed.kind == ref.kind
    syms = npz["symbols"]
    assert parsed.n_symbols == len(syms)
    np.testing.assert_array_equal(parsed.stream, ref.stream)
    np.testing.assert_array_equal(parsed.final_states, ref.final_states)
    np.testing.assert_array_equal(parsed.model.f, ref.model.f)
    assert metadata.serialize_plan(parsed.plan) == \
        j_metadata.serialize_plan(ref.plan)
    out = recoil.decode_recoil(parsed.plan, parsed.stream,
                               parsed.final_states, parsed.model)
    np.testing.assert_array_equal(out, syms)
    # Re-encoding the frozen symbols with the port reproduces the bytes.
    enc = encode_interleaved_fast(syms, parsed.model)
    np.testing.assert_array_equal(enc.k_of_word, npz["k_of_word"])
    plan = recoil.plan_splits(enc, int(npz["n_splits"]))
    if parsed.kind == container.KIND_RECOIL_CHUNKED:
        for key in ("sym_end", "words_end", "split_end"):
            np.testing.assert_array_equal(getattr(parsed.chunks, key),
                                          npz[key])
        again = container.pack_recoil_chunked(enc, parsed.model, plan,
                                              int(npz["n_chunks"]))
    else:
        again = container.pack_recoil(enc, parsed.model, plan)
    assert again == buf


@pytest.mark.parametrize("ways,n_bits,family", [
    (32, 11, "gaussian"), (16, 10, "laplacian")])
@in_child
def test_adaptive_equals_reference(ways, n_bits, family):
    """The copied adaptive module: context tables, the adaptive encoder's
    stream and emission log, and the adaptive Recoil decode, equal to the
    reference's; ``convert.context_model_from_arrays`` carries a reference
    model across unchanged."""
    from repro_torch.core import adaptive, convert, rans, recoil
    n = 3_001
    ctx = (np.arange(n) // 97 % 3).astype(np.int32)
    scales = [4.0, 12.0, 40.0]
    jcm = j_adaptive.ContextModel.from_scale_table(
        scales, ctx, 256, j_rans.RansParams(n_bits=n_bits, ways=ways),
        family=family)
    tcm = adaptive.ContextModel.from_scale_table(
        scales, ctx, 256, rans.RansParams(n_bits=n_bits, ways=ways),
        family=family)
    carried = convert.context_model_from_arrays(jcm.f, jcm.F, jcm.ctx,
                                                n_bits, ways)
    for model in (tcm, carried):
        for field in ("f", "F", "ctx"):
            np.testing.assert_array_equal(getattr(model, field),
                                          getattr(jcm, field))
            assert getattr(model, field).dtype == getattr(jcm, field).dtype
        np.testing.assert_array_equal(model.slot_luts(), jcm.slot_luts())
    syms = _symbols(ways, n, alphabet=256, lam=30.0)
    a = j_adaptive.encode_interleaved_adaptive(syms, jcm)
    b = adaptive.encode_interleaved_adaptive(syms, tcm)
    for field in ("stream", "final_states", "k_of_word", "y_of_word"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
        assert getattr(b, field).dtype == getattr(a, field).dtype, field
    jp = j_recoil.plan_splits(a, 6)
    tp = recoil.plan_splits(b, 6)
    out = adaptive.decode_recoil_adaptive(tp, b.stream, b.final_states, tcm)
    np.testing.assert_array_equal(
        out, j_adaptive.decode_recoil_adaptive(jp, a.stream, a.final_states,
                                               jcm))
    np.testing.assert_array_equal(out, syms)
    with pytest.raises(ValueError, match="exclusive CDFs"):
        convert.context_model_from_arrays(jcm.f, jcm.F[:, :-1], jcm.ctx,
                                          n_bits, ways)


SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _source(package, module):
    with open(os.path.join(SRC, package, *module.split("/"))) as f:
        return f.read()


def _code_lines(text):
    """The lines of a module other than its import statements."""
    return [line for line in text.splitlines()
            if not line.startswith(("import ", "from "))]


def _code_only(text):
    """The code of a module: no docstrings, comments, imports or blank
    lines, each line without trailing space."""
    skip = set()
    for node in ast.walk(ast.parse(text)):
        if (isinstance(node, (ast.Import, ast.ImportFrom))
                or (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str))):
            skip.update(range(node.lineno, node.end_lineno + 1))
    lines = text.splitlines()
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type == tokenize.COMMENT:
            row, col = tok.start
            lines[row - 1] = lines[row - 1][:col]
    return [line.rstrip() for i, line in enumerate(lines, 1)
            if i not in skip and line.strip()]


_WAIT_READY = [
    "def _wait_ready(tickets) -> None:",
    "    events = {id(t.ready): t.ready for t in tickets"
    " if t.ready is not None}",
    "    for ev in events.values():",
    "        ev.synchronize()",
    "def _on_device(device):",
    '    if device.type != "cuda":',
    "        return contextlib.nullcontext()",
    "    return torch.cuda.device(device)"]
_GROUP_WAIT = ["jax.block_until_ready(",
               "    [t.out for t in tickets if t.out is not None])"]

# The tuner times a warm probe on the card with CUDA events queued behind a
# device sleep and read after a synchronize, and the first call's extra host
# time on the host's clock; on the CPU both with the host clock.
_TIMED = [
    "    def _timed(self, fn) -> tuple:",
    '        if self.device.type != "cuda":',
    "            t0 = time.perf_counter()",
    "            fn()",
    "            s = time.perf_counter() - t0",
    "            return s, s",
    "        torch.cuda.synchronize(self.device)",
    "        e0 = torch.cuda.Event(enable_timing=True)",
    "        e1 = torch.cuda.Event(enable_timing=True)",
    "        torch.cuda._sleep(_SLEEP_CYCLES)",
    "        e0.record()",
    "        t0 = time.perf_counter()",
    "        fn()",
    "        host_s = time.perf_counter() - t0",
    "        e1.record()",
    "        torch.cuda.synchronize(self.device)",
    "        return host_s, e0.elapsed_time(e1) * 1e-3"]
_TIMED_WARM = ["t0 = time.perf_counter()",
               "jax.block_until_ready(sess.execute(plan))",
               "warm.append(time.perf_counter() - t0)"]

# The only code the forks change, as (reference lines, port lines) hunks in
# file order.  Broker and predictor: each ``jax.block_until_ready`` becomes a
# wait on the launch's readiness event, the workers run on the service's
# device and the ticket's ``result()`` waits on its event.  Tuning database:
# the user cache's directory, and the platform is the impl's device type
# (``platform_of``) where the reference asks ``jax.default_backend()``.
# A sharded session passes its mesh's device type to ``resolve_policy``
# as the platform (``platform_of`` knows only the device-fixed impls).
# Tuner: the device fixes the impl (no ``interpret``), probes are timed by
# ``_timed`` (the compile term from host times, the execute term from device
# times), sessions run on the tuner's device, the block sweep runs on the
# ``cuda`` impl where the reference's runs on ``pallas``, and a sweep
# candidate with a wrong output raises where the reference's marks it
# invalid.
_FORK_HUNKS = {
    "runtime/pipeline/broker.py": [
        ([], _WAIT_READY),
        ([], ["        if self.ready is not None:",
              "            self.ready.synchronize()"]),
        ([" " * 20 + line for line in _GROUP_WAIT],
         [" " * 20 + "_wait_ready(tickets)"]),
        (["        self._supervise(self._decode_main, self._recover_decode)"],
         ["        with _on_device(self.svc.session.device):",
          "            self._supervise(self._decode_main,"
          " self._recover_decode)"]),
        (["        self._supervise(self._ingest_main, self._recover_ingest)"],
         ["        with _on_device(self.svc.session.device):",
          "            self._supervise(self._ingest_main,"
          " self._recover_ingest)"]),
        (["            jax.block_until_ready(ticket.chunk(ticket.n_chunks"
          " - 1))"],
         ["            ticket.synchronize(ticket.n_chunks - 1)"]),
        ([" " * 12 + line for line in _GROUP_WAIT],
         [" " * 12 + "_wait_ready(tickets)"]),
        (["                jax.block_until_ready(",
          "                    [ticket.out] if ticket.out is not None"
          " else [])"],
         ["                _wait_ready([ticket])"]),
    ],
    "runtime/pipeline/predictor.py": [
        (["            jax.block_until_ready(self._svc.session.execute(plan))"],
         ["            ready = _launched(self._svc.session.execute(plan))",
          "            if ready is not None:",
          "                ready.synchronize()"]),
    ],
    "core/tuning/db.py": [
        (['    return pathlib.Path(cache) / "repro-recoil" / "tuning.json"'],
         ['    return pathlib.Path(cache) / "repro-recoil-torch"'
          ' / "tuning.json"']),
        ([], ["def platform_of(impl: str) -> str:",
              '    if impl not in ("cuda", "torch"):',
              '        raise ValueError(f"unknown impl {impl!r} (the port\'s'
              ' impls are "',
              "                         \"'cuda' and 'torch')\")",
              '    return "cuda" if impl == "cuda" else "cpu"']),
        (["        platform = jax.default_backend()"],
         ["        platform = platform_of(impl)"]),
        (["def resolve_policy(policy, *, impl: str,",
          "                   layout: str) -> tuple[BucketPolicy,"
          " Profile | None]:"],
         ["def resolve_policy(policy, *, impl: str, layout: str,",
          "                   platform: str | None = None",
          "                   ) -> tuple[BucketPolicy, Profile | None]:"]),
        (["        prof = resolve_profile(impl=impl, layout=layout)"],
         ["        prof = resolve_profile(impl=impl, layout=layout,"
          " platform=platform)"]),
    ],
    "core/tuning/tuner.py": [
        ([], ["_SLEEP_CYCLES = 10_000_000"]),
        (['    def __init__(self, model=None, *, impl: str = "jnp",'],
         ['    def __init__(self, model=None, *, device="cuda",'
          ' impl: str | None = None,']),
        (["                 n_splits: int = 16, seed: int = 7,"
          " platform: str | None = None,",
          "                 interpret: bool = True):"],
         ["                 n_splits: int = 16, seed: int = 7,",
          "                 platform: str | None = None):",
          "        self.device = resolve_device(device)",
          '        own = "cuda" if self.device.type == "cuda" else "torch"',
          "        if impl is not None and impl != own:",
          "            raise ValueError(",
          '                f"impl={impl!r} does not run on {self.device}:'
          ' the device "',
          '                f"fixes the impl ({own!r})")',
          "        impl = own"]),
        (["        self.interpret = interpret"], []),
        (["            platform = jax.default_backend()"],
         ["            platform = platform_of(impl)"]),
        (["        return DecoderSession(self.model, impl=self.impl,"
          " layout=self.layout,",
          "                              interpret=self.interpret,"
          " policy=policy, **kw)"],
         ["        return DecoderSession(self.model, device=self.device,",
          "                              layout=self.layout, policy=policy,"
          " **kw)"]),
        ([], _TIMED),
        (["        t0 = time.perf_counter()",
          "        jax.block_until_ready(sess.execute(plan))",
          "        first_s = time.perf_counter() - t0",
          "        warm = []",
          "        for _ in range(self.repeats):",
          *(" " * 12 + line for line in _TIMED_WARM),
          "        warm_s = float(np.median(warm))"],
         ["        first_s, _ = self._timed(lambda: sess.execute(plan))",
          "        warm = [self._timed(lambda: sess.execute(plan))",
          "                for _ in range(self.repeats)]",
          "        warm_host_s = float(np.median([h for h, _ in warm]))",
          "        warm_s = float(np.median([d for _, d in warm]))"]),
        (["        return max(first_s - warm_s, 0.0), warm_s"],
         ["        return max(first_s - warm_host_s, 0.0), warm_s"]),
        (['        timed = self.platform in ("gpu", "cuda", "rocm", "tpu")'],
         ['        timed = self.device.type == "cuda"']),
        (['            sess = DecoderSession(self.model, impl="pallas",',
          "                                  interpret=not timed,"
          " rows_per_block=rpb,",
          "                                  layout=self.layout,"
          ' policy="legacy")'],
         ["            sess = DecoderSession(self.model, device=self.device,",
          "                                  rows_per_block=rpb,"
          " layout=self.layout,",
          '                                  policy="legacy")']),
        (['            out = np.asarray(sess.decode_batch(req["batch"], ds,'
          ' req["n"]))'],
         ['            out = sess.decode_batch(req["batch"], ds,'
          ' req["n"]).cpu().numpy()']),
        (['                results[rpb] = {"valid": False}',
          "                continue"],
         ['                raise RuntimeError(f"rows_per_block={rpb}: the'
          ' walk\'s "',
          '                                   "output is not the input'
          ' symbols")']),
        (["                warm = []",
          "                for _ in range(self.repeats):",
          *(" " * 20 + line for line in _TIMED_WARM)],
         ["                warm = [self._timed(lambda: sess.execute(plan))[1]",
          "                        for _ in range(self.repeats)]"]),
        (['        if self.impl == "pallas":'],
         ['        if self.impl == "cuda":']),
    ],
}


@pytest.mark.parametrize("module", [
    "runtime/observability/trace.py", "runtime/observability/registry.py",
    "runtime/observability/profiler.py", "runtime/faultinject.py",
    "runtime/metrics.py", "runtime/pipeline/controller.py",
    "runtime/pipeline/capability.py", "runtime/pipeline/broker.py",
    "runtime/pipeline/predictor.py", "core/tuning/db.py",
    "core/tuning/tuner.py", "runtime/fault.py"])
@in_child
def test_copied_runtime_sources_equal_reference(module):
    """The jax-free runtime modules are copies: their text equals the
    reference's, apart from docstring references to the package name,
    import lines (``capability.py`` imports the port's ``core``), and two
    stated reads of the port's int16 resident words: in ``faultinject.py``
    the body of ``drop_last_word`` (held by tests/test_torch_reliability.py)
    and in ``capability.py`` the one line that copies a card stream's words
    to the host through ``.cpu()`` where the reference's ``np.asarray``
    would refuse a CUDA tensor (held by tests/test_torch_pipeline.py).
    The broker, the predictor, the tuning database and the tuner are
    forks: their docstrings and comments speak of the port, and their code
    (no docstrings, comments or imports) differs from the reference's in the
    hunks of ``_FORK_HUNKS`` alone.  The broker keeps the reference's
    controller config from a tuning profile."""
    if module in _FORK_HUNKS:
        ref = _code_only(_source("repro", module))
        port = _code_only(_source("repro_torch", module))
        match = difflib.SequenceMatcher(a=ref, b=port, autojunk=False)
        hunks = [(ref[i1:i2], port[j1:j2])
                 for op, i1, i2, j1, j2 in match.get_opcodes()
                 if op != "equal"]
        assert hunks == _FORK_HUNKS[module]
        return
    ref = _source("repro", module).replace("repro.runtime.",
                                           "repro_torch.runtime.")
    port = _source("repro_torch", module)
    if module.endswith("faultinject.py"):
        cut = "def drop_last_word(stream):"
        ref, port = ref[:ref.index(cut)], port[:port.index(cut)]
    if module.endswith("capability.py"):
        ref = ref.replace("else np.asarray(ds.words[:ds.n_words]))",
                          "else ds.words[:ds.n_words].cpu().numpy())")
        ref, port = _code_lines(ref), _code_lines(port)
    assert port == ref


@in_child
def test_data_copies_equal_reference():
    """``data/pipeline.py``'s ``DataConfig``, ``SyntheticCorpus`` and
    ``ShardedCorpus`` are copies: each class's text equals the
    reference's (the fork is ``RecoilShardStore``)."""
    def classes(package):
        text = _source(package, "data/pipeline.py")
        return {node.name: ast.get_source_segment(text, node)
                for node in ast.parse(text).body
                if isinstance(node, ast.ClassDef)}
    ref, port = classes("repro"), classes("repro_torch")
    assert sorted(port) == sorted(ref) == [
        "DataConfig", "RecoilShardStore", "ShardedCorpus", "SyntheticCorpus"]
    for name in ("DataConfig", "SyntheticCorpus", "ShardedCorpus"):
        assert port[name] == ref[name], name
    assert port["RecoilShardStore"] != ref["RecoilShardStore"]


CONFIG_MODULES = sorted(
    os.path.relpath(p, os.path.join(SRC, "repro"))
    for p in glob.glob(os.path.join(SRC, "repro", "configs", "*.py")))
# The config registry imports each architecture's module by name, and the
# port's names its own package.
_CONFIG_IMPORTS = [
    ('        importlib.import_module(f"repro.configs.{key}")',
     '        importlib.import_module(f"repro_torch.configs.{key}")'),
    ('    mod = importlib.import_module(f"repro.configs.{key}")',
     '    mod = importlib.import_module(f"repro_torch.configs.{key}")')]


@pytest.mark.parametrize("module", CONFIG_MODULES)
@in_child
def test_config_sources_equal_reference(module):
    """``configs/`` is copied: every module's text equals the reference's,
    apart from ``base.py``'s two lines that import an architecture's
    module by name (``get_config``, ``get_smoke_config``)."""
    ref = _source("repro", module).splitlines()
    port = _source("repro_torch", module).splitlines()
    match = difflib.SequenceMatcher(a=ref, b=port, autojunk=False)
    hunks = [(line_a, line_b)
             for op, i1, i2, j1, j2 in match.get_opcodes() if op != "equal"
             for line_a, line_b in zip(ref[i1:i2], port[j1:j2])]
    assert len(ref) == len(port)
    assert hunks == (_CONFIG_IMPORTS if module.endswith("base.py") else [])
    assert len(CONFIG_MODULES) == 12


@in_child
def test_builtin_tuning_profiles_equal_reference():
    """The committed CPU defaults are a byte copy of the reference's: a
    hand-written ladder (``measurements: 0``), not a timing, and no
    ``cuda:`` profile."""
    import json
    from repro.core.tuning import builtin_db_path as j_builtin
    from repro_torch.core.tuning import builtin_db_path
    data = builtin_db_path().read_bytes()
    assert data == j_builtin().read_bytes()
    profiles = json.loads(data)["profiles"]
    assert not [k for k in profiles if k.startswith("cuda:")]
    assert {p["measurements"] for p in profiles.values()} == {0}

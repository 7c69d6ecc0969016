"""The port's examples (``examples/quickstart_torch.py``,
``examples/content_delivery_torch.py``) run on the CPU through their
``main(device="cpu")``; each asserts its own decodes equal the payload.

The quickstart runs at its own size (2 M symbols).  The content-delivery
demos run at smaller sizes set through the example's module-level sizes:
at the reference's (a 4 M-symbol payload, a 500 k-symbol capability asset)
the plain torch walks take over two minutes on the CPU.  Each test runs in
a child pytest process (``test_torch_isolation.in_child``).
"""

import importlib.util
import os

from test_torch_isolation import in_child

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@in_child
def test_quickstart_runs_on_the_cpu(capsys):
    _example("quickstart_torch").main(device="cpu")
    out = capsys.readouterr().out
    for line in ("client@2176: engine decode OK (2176 threads, plain walk)",
                 "client@16: engine decode OK (16 threads, plain walk)",
                 "client@64: decode_recoil_kernel OK (plain walk)"):
        assert line in out, out


@in_child
def test_content_delivery_runs_on_the_cpu(capsys):
    ex = _example("content_delivery_torch")
    ex.PAYLOAD_SIZE = 200_000
    ex.CAPABILITY_SIZE = 50_000
    ex.main(device="cpu")
    out = capsys.readouterr().out
    warm = [line for line in out.splitlines() if "new compiles:" in line]
    assert len(warm) == 4 and all("new compiles: 0," in w for w in warm), out
    assert "via 2 fused dispatches" in out, out
    assert "0 compiles in the predictive window" in out, out
    for section in ("capability negotiation", "predictive hot-set serving",
                    "unified snapshot:", "decode executor:"):
        assert section in out, out

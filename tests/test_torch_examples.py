"""The port's examples (``examples/quickstart_torch.py``,
``examples/content_delivery_torch.py``, ``examples/train_lm_torch.py``,
``examples/checkpoint_distribution_torch.py``) run on the CPU through their
``main(device="cpu")``; each asserts its own decodes equal the payload.

The training driver runs its ``tiny`` preset for 20 steps in a process of
its own, is killed with SIGTERM after its first step (its preemption guard
saves a checkpoint and exits) and is relaunched, resuming from that
checkpoint.  The checkpoint distribution demo runs at a smaller size set
through its module-level sizes.

The quickstart runs at its own size (2 M symbols).  The content-delivery
demos run at smaller sizes set through the example's module-level sizes:
at the reference's (a 4 M-symbol payload, a 500 k-symbol capability asset)
the plain torch walks take over two minutes on the CPU.  Each test runs in
a child pytest process (``test_torch_isolation.in_child``).
"""

import importlib.util
import os
import signal
import subprocess
import sys

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


def _train(ckpt_dir, *extra):
    env = {**os.environ, "PYTHONPATH": os.path.join(EXAMPLES, "..", "src")}
    return subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, "train_lm_torch.py"),
         "--preset", "tiny", "--steps", "20", "--ckpt-every", "5",
         "--ckpt-dir", ckpt_dir, "--device", "cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


@in_child
def test_train_lm_is_killed_and_resumes_on_the_cpu(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _train(ckpt)
    lines = []
    for line in first.stdout:
        lines.append(line)
        if line.startswith("[metrics] step=0"):
            first.send_signal(signal.SIGTERM)
            break
    lines += first.stdout.readlines()
    assert first.wait(timeout=300) == 0, "".join(lines)
    out = "".join(lines)
    assert "model: lmtiny" in out and "preempted at step" in out, out
    stopped = int(out.split("preempted at step ")[1].split(";")[0])
    assert stopped < 19, out
    second = _train(ckpt)
    out2, _ = second.communicate(timeout=300)
    assert second.returncode == 0, out2
    assert f"restored from step {stopped + 1} (recoil-coded checkpoint" \
        in out2, out2
    assert "[metrics] step=10" in out2 and "done; final loss:" in out2, out2
    loss = float(out2.split("done; final loss:")[1].split()[0])
    assert loss == loss and loss < 6.3, out2


@in_child
def test_checkpoint_distribution_runs_on_the_cpu(capsys):
    from repro_torch.configs.base import ArchConfig
    ex = _example("checkpoint_distribution_torch")
    ex.CONFIG = ArchConfig(name="ckpt_demo", family="dense", n_layers=2,
                           d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                           vocab=1024, remat="none")
    ex.SEQ_LEN, ex.BATCH, ex.TRAIN_STEPS = 32, 4, 3
    ex.main(device="cpu")
    out = capsys.readouterr().out
    assert "trained 3 steps, loss" in out, out
    assert "metadata at 256-way parallelism" in out, out
    losses = [float(line.rsplit("next-step loss ", 1)[1])
              for line in out.splitlines() if "next-step loss" in line]
    assert len(losses) == 3 and max(losses) - min(losses) < 0.05, out
    assert "all hosts resumed" in out, out

"""The example and tool twins on the CPU.

* ``examples/torch_quickstart.py``, ``examples/torch_ragged_batch.py`` and
  ``examples/torch_serve_decode.py`` each run with ``--device cpu`` and
  exit 0;
* the quickstart's three losses, and its loss at (6, 256), are within 2e-4
  relative of the reference example's (``examples/quickstart.py``, run in
  a subprocess; its (6, 256) loss read from the script's globals): both
  draw their inputs from ``RandomState(0)`` in the same order;
* the ragged batch's valid and measured row counts are exactly the
  reference example's;
* ``tools/torch_memview.py``'s ``render_timeline`` draws one row per
  lowered instruction, and its CLI exits 1 on a diff that is not ok.
Peaks are each package's own and are not compared.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def _run(*args, timeout=600):
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


def _losses(text):
    return [float(x) for x in re.findall(r"loss=\s*([-\d.]+)", text)]


def test_quickstart_losses_are_the_references():
    ours = _run("examples/torch_quickstart.py", "--device", "cpu")
    ref = _run("-c", "import runpy; g = runpy.run_path("
               "'examples/quickstart.py'); "
               "print('LOSS_FREE', float(g['loss_free']))")
    got, want = _wait(ours), _wait(ref)
    got_l = _losses(got)
    want_l = _losses(want)[:3]
    want_l.append(float(re.search(r"LOSS_FREE ([-\d.e]+)", want).group(1)))
    assert len(got_l) == 4 and len(want_l) == 4
    for g, w in zip(got_l, want_l):
        assert abs(g - w) <= 2e-4 * abs(w), (got_l, want_l)
    assert "guaranteed peak" in got and "memory planner" in got


def _ragged_rows(text):
    """(rows, valid, measured) of each request line."""
    return [tuple(int(x) for x in (m.group(1), m.group(2), m.group(3)))
            for m in re.finditer(r"^\s*(\d+)\s+(\d+)\s+\(\d+,?\)\s+(\d+)",
                                 text, re.M)]


def test_ragged_batch_counts_are_the_references():
    ours = _run("examples/torch_ragged_batch.py", "--device", "cpu")
    ref = _run("examples/ragged_batch.py")
    got, want = _ragged_rows(_wait(ours)), _ragged_rows(_wait(ref))
    assert len(got) == 5 and got == want


def test_serve_decode_runs():
    out = _wait(_run("examples/torch_serve_decode.py", "--device", "cpu"))
    assert "plan is O(body)" in out
    for arch in ("llama2-1b", "gemma-2b", "deepseek-v3-671b", "xlstm-1.3b",
                 "hymba-1.5b"):
        assert arch in out


def _memview():
    spec = importlib.util.spec_from_file_location(
        "torch_memview", ROOT / "tools" / "torch_memview.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mlp(w1, w2, x):
    return (torch.tanh(x @ w1) @ w2).sum()


def test_render_timeline_draws_a_row_per_instruction():
    from repro_torch.core import TensorSpec, optimize, symbolic_dims
    B, = symbolic_dims("b")
    f32 = torch.float32
    fn = optimize(_mlp, TensorSpec((16, 32), f32), TensorSpec((32, 16), f32),
                  TensorSpec((B, 16), f32), dynamic_dims={"b": (1, 64)},
                  device="cpu")
    diff = fn.memory_timeline({"b": 8})
    text = _memview().render_timeline(diff, width=20)
    lines = text.splitlines()
    rows = lines[2:lines.index("")]
    assert len(rows) == len(diff.actual.points) > 0
    assert all(len(r.split()) >= 4 for r in rows)
    assert lines[-1] == diff.summary() and diff.ok


def test_memview_exits_1_on_a_diff_that_is_not_ok(monkeypatch, capsys):
    from repro_torch.core.api import DynamicShapeFunction
    real = DynamicShapeFunction.memory_timeline

    def broken(self, env):
        diff = real(self, env)
        diff.arena_bound_bytes = 0            # the arena above its bound
        return diff
    monkeypatch.setattr(DynamicShapeFunction, "memory_timeline", broken)
    view = _memview()
    assert view.main(["--arch", "gemma_2b", "--env", "b=2,s=32",
                      "--device", "cpu"]) == 1
    assert "False" in capsys.readouterr().out
    assert view.main(["--arch", "internvl2_2b", "--device", "cpu"]) == 2

"""A run loads no module whose top-level name is, whole, ``jax``,
``jaxlib``, ``flax``, ``optax`` or ``cst_captioning_tpu`` (the port's own
name begins with the last); without a CUDA device the command prints no
result and exits 2."""

import os
import subprocess
import sys
import textwrap

from _tiny import BENCH, ROOT


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)


def test_a_run_of_each_cell_loads_no_jax():
    got = _python(f"""
        import sys
        sys.path[:0] = [{ROOT!r}, {BENCH!r}, {os.path.join(BENCH, 'tests')!r}]
        import torch
        import run
        from _tiny import CELLS, tiny_cell
        from cstbench import session
        for name in CELLS:
            session.run(tiny_cell(name), 11, 0.2, False,
                        torch.device("cpu"), 0.0)
        assert any(m.startswith("cst_captioning_tpu_torch")
                   for m in sys.modules)
        print("FOUND", run.forbidden_modules())
        """)
    assert got.returncode == 0, got.stderr[-3000:]
    assert "FOUND []" in got.stdout


def test_the_check_compares_whole_top_level_names():
    got = _python(f"""
        import sys, types
        sys.path[:0] = [{ROOT!r}, {BENCH!r}]
        import run
        import cst_captioning_tpu_torch.ops
        assert run.forbidden_modules() == [], run.forbidden_modules()
        sys.modules["cst_captioning_tpu.models"] = types.ModuleType("m")
        sys.modules["jaxlib"] = types.ModuleType("jaxlib")
        print("FOUND", run.forbidden_modules())
        """)
    assert got.returncode == 0, got.stderr[-3000:]
    assert "FOUND ['cst_captioning_tpu', 'jaxlib']" in got.stdout


def test_no_cuda_device_no_result():
    got = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "attlstm-cst", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert got.returncode == 2
    assert got.stdout.strip() == ""

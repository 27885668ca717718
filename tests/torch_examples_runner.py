"""Runs scripts of ``examples_torch/`` on the CPU for the
``test_torch_examples_*`` files: one subprocess (``TTNX_TORCH_CPU=1``, one
torch thread) runs the given scripts one after another with ``runpy``, as
``chip_smoke.py``'s phase 14 does on the card, and reports each script's
outcome, wall time and output. The subprocess imports no jax.

Run directly, it is that subprocess: ``python tests/torch_examples_runner.py
NAME...`` prints one JSON object a script.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples_torch"


def run_scripts(names, timeout: float) -> dict:
    """``{name: {"ok", "seconds", "error", "stdout"}}`` for each script."""
    env = dict(os.environ, TTNX_TORCH_CPU="1", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), *names], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=timeout)
    out = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            out[rec.pop("name")] = rec
    missing = [n for n in names if n not in out]
    if missing:
        raise RuntimeError(f"runner exited {proc.returncode} before "
                           f"{missing}:\n{proc.stderr[-4000:]}")
    return out


def _main(names) -> None:
    import contextlib
    import io
    import runpy
    import time
    import traceback

    import torch

    torch.set_num_threads(1)
    for name in names:
        buf = io.StringIO()
        t0 = time.perf_counter()
        error = None
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(EXAMPLES / f"{name}.py"),
                               run_name="__main__")
        except Exception:  # the script's failure is the result
            error = traceback.format_exc(limit=-3)
        print(json.dumps({"name": name, "ok": error is None,
                          "seconds": time.perf_counter() - t0,
                          "error": error, "stdout": buf.getvalue()}),
              flush=True)


if __name__ == "__main__":
    _main(sys.argv[1:])

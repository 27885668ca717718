"""The import guard: nothing that a run loads has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``ttnx`` (compared whole: the port's own
name begins with ``ttnx``), and the plain references load nothing of the
port."""

import json
import subprocess
import sys

import pytest

from portbench.core import guard
from portbench.core.catalog import PACKAGE, REPO

CONFIGS = sorted(p.stem for p in (PACKAGE / "reference").glob("heat_*.py"))


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\n"
         "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("from portbench.core.catalog import Catalog\n"
            "from portbench.core import harness\n"
            "import portbench.run, portbench.calibrate\n"
            "c = Catalog()\n"
            "for w in c.benchmark['workloads']:\n"
            "    for kind in ('drivers', 'reference', 'work'):\n"
            "        c.module(kind, w['config'])\n"
            "for m in c.benchmark['end_to_end'] + c.benchmark['per_layer']:\n"
            "    c.reader(m['name'])\n")
    tops = loaded_after(code)
    assert "ttnx_torch" in tops and "torch" in tops
    assert not tops & set(guard.FORBIDDEN)


@pytest.mark.parametrize("config", CONFIGS)
def test_references_load_nothing_of_the_port(config):
    tops = loaded_after(f"import portbench.reference.{config}")
    assert not tops & (set(guard.FORBIDDEN) | {guard.PORT})
    assert guard.PORT not in guard.imported_tops(
        PACKAGE / "reference" / f"{config}.py")


def test_guard_names_whole_top_level_names(tmp_path):
    assert guard.forbidden_loaded(["ttnx_torch.core", "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["ttnx.core", "jax.numpy", "torch"]) == [
        "jax", "ttnx"]
    bad = tmp_path / "ref.py"
    bad.write_text("import numpy\nfrom ttnx_torch.core import tt\n")
    with pytest.raises(RuntimeError, match="ttnx_torch"):
        guard.check_reference(bad)
    for config in CONFIGS:
        guard.check_reference(PACKAGE / "reference" / f"{config}.py")

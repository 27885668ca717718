"""The harness on the CPU: cells that exist only in the test fixture run with
no edit to any file, the result line has the keys the contract reads, a
broken timed path makes ``correct`` false, and the trace readers count
what a synthetic trace holds.

The fixture (``fixtures/tiny``) holds two small cells of the two heat
configurations (d = 8, rank 8, float32 on the CPU, where the port takes
its kernels' plain versions), a ``BENCHMARK.json`` of its own, and
one-line driver, reference and work modules that reuse the package's.
"""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench.calibrate import planted
from portbench.core import harness
from portbench.core.catalog import PACKAGE, REPO, Catalog
from portbench.core.trace import Trace, parse
from portbench.core.traffic import sampled
from portbench.core.window import Window
from portbench.drivers import heat_batch_d12_r64, heat_cn_d12_r64
from ttnx_torch.solvers import als_scan_batched, round_scan

FIXTURE = PACKAGE / "tests" / "fixtures" / "tiny"
CN, BATCH = "tiny_cn.tiny_stream", "tiny_batch.tiny_b8"
SEED = 2**31 + 5
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def one_thread():
    """The fixture cells are small: one torch thread keeps a run cheap."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def catalog():
    return Catalog(roots=[FIXTURE, PACKAGE], benchmark=FIXTURE / "BENCHMARK.json")


def run(cell, trace=False, seed=SEED, seconds=0.6):
    return harness.run_cell(catalog(), cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell", [CN, BATCH])
@pytest.mark.parametrize("seed", [SEED, 7])
def test_fixture_cell_runs_and_is_correct(cell, seed):
    r = run(cell, seed=seed)
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == set(catalog().cell(cell)["limits"])
    moved = {"cn_step_ms", "cn_step_p95_ms"} if cell == CN else {"solves_per_s"}
    assert set(r["metrics"]) == moved | {"setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])


@pytest.mark.parametrize("cell", [CN, BATCH])
def test_traced_run_adds_the_breakdown_and_window(cell):
    r = run(cell, trace=True)
    assert list(r) == KEYS + ["breakdown", "checks"]
    assert r["correct"] is True
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU trace holds no device operation: every device reader is silent
    assert r["metrics"] == {}


@pytest.mark.parametrize("cell,fault", [
    (CN, "unchanged"), (CN, "altered"), (BATCH, "unchanged"),
    (BATCH, "half"), (BATCH, "altered")],
    ids=["cn-unchanged", "cn-altered", "batch-unchanged", "batch-half",
         "batch-altered"])
def test_broken_timed_path_is_not_correct(cell, fault):
    """Each fault of the cell's ``faults`` module, planted under the timed
    path as the calibration plants it, makes ``correct`` false."""
    cat = catalog()
    with planted(cat, cell, fault):
        r = harness.run_cell(cat, cell, SEED, 0.6, False,
                             torch.device("cpu"), time.perf_counter())
    assert r["correct"] is False and r["failed"] > 0
    assert heat_cn_d12_r64.make_cn_step is round_scan.make_cn_step
    assert heat_batch_d12_r64.als_sweeps_b is als_scan_batched.als_sweeps_b


def test_judged_sample_grows_with_the_log_of_the_units():
    """One unit in ``every`` of the first ``span`` is judged, and each
    doubling of the units after them adds about as many again as half the
    first span did, so a much faster program keeps few more outputs."""
    def kept(n):
        return sum(sampled(SEED, i, 4, 128) for i in range(n))
    assert 20 <= kept(128) <= 44
    assert kept(128 * 64) < 12 * kept(128) // 2 + kept(128)
    assert [sampled(SEED, i, 4, 128) for i in range(50)] == \
        [sampled(SEED, i, 4, 128) for i in range(50)]


def test_judge_counts_answers_over_their_limits():
    n, failed, checks = harness.judge(
        {"a": [1e-6, 2e-3, 1e-6], "b": [1e-6, 1e-6, float("nan")]},
        {"a": 1e-3, "b": 1e-3})
    assert (n, failed) == (3, 2)
    assert checks["a"] == {"value": 2e-3, "limit": 1e-3}
    assert checks["b"]["value"] != checks["b"]["value"]  # nan
    with pytest.raises(KeyError):
        harness.judge({"a": [0.0]}, {"b": 1.0})


def test_cells_agree_with_the_benchmark_file():
    cat = Catalog()
    bench = cat.benchmark
    for w in bench["workloads"]:
        cell = cat.cell(w["name"])
        assert cell["why"] == w["why"]
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        for kind in ("drivers", "reference", "work"):
            cat.find(f"{kind}/{w['config']}.py")
        cat.data("traffic", w["traffic"])
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert (cfg["name"], cfg["source"], cfg["reduced"]) == \
            (c["name"], c["source"], c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cat.reader(m["name"]))


def test_metric_lists_follow_the_workloads_keys():
    cat = Catalog()
    names = {w["name"] for w in cat.benchmark["workloads"]}
    for cell in names:
        e2e = {m["name"] for m in cat.metrics(cell, "end_to_end")}
        layer = cat.metrics(cell, "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
    assert {m["name"] for m in cat.metrics("heat_cn_d12_r64.stream",
                                           "per_layer")} == {
        "host_syncs.cn", "kernel_launches.cn", "step_roofline.cn",
        "idle_share.cn"}


def test_metric_without_workloads_goes_where_its_moved_metric_is():
    """A per-layer entry with no ``workloads`` key is reported in every cell
    that reports the end-to-end metric it moves (the fixture's
    ``kernel_launches.all`` moves ``solves_per_s``)."""
    cat = catalog()
    names = {c: {m["name"] for m in cat.metrics(c, "per_layer")}
             for c in (CN, BATCH)}
    assert "kernel_launches.all" in names[BATCH]
    assert "kernel_launches.all" not in names[CN]


def synthetic_trace(tmp_path):
    """Two units: kernels at [10, 30] and [25, 40] us, a copy at [60, 70],
    the window [0, 100] with its units [0, 90]; a synchronize in the units
    and the window's closing one, and a launch call; host operators
    ``aten::mm`` [0, 50] holding ``aten::eigh`` [40, 58]."""
    ev = [
        dict(ph="X", cat="user_annotation", name="portbench.window", ts=0,
             dur=100, tid=1),
        dict(ph="X", cat="user_annotation", name="portbench.units", ts=0,
             dur=90, tid=1),
        dict(ph="X", cat="cuda_runtime", name="cudaDeviceSynchronize",
             ts=91, dur=8, tid=1),
        dict(ph="X", cat="kernel", name="k1", ts=10, dur=20, tid=7),
        dict(ph="X", cat="kernel", name="k2", ts=25, dur=15, tid=7),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=60, dur=10,
             tid=7),
        dict(ph="X", cat="kernel", name="outside", ts=150, dur=10, tid=7),
        dict(ph="X", cat="cuda_runtime", name="cudaStreamSynchronize",
             ts=52, dur=19, tid=1),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=9,
             dur=1, tid=1),
        dict(ph="X", cat="cpu_op", name="aten::mm", ts=0, dur=50, tid=1),
        dict(ph="X", cat="cpu_op", name="aten::eigh", ts=40, dur=18, tid=1),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return parse(path, units=2, wall_s=1e-4)


def test_trace_parse_and_readers(tmp_path):
    tr = synthetic_trace(tmp_path)
    assert isinstance(tr, Trace)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.kernel_s == pytest.approx(30e-6)
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.host_syncs == 1
    assert [round(a * 1e6) for a, _ in tr.gaps()] == [0, 40, 70]
    assert tr.gap_labels() == ["aten::mm", "aten::eigh", "python"]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"aten::mm": 10e-6, "aten::eigh": 20e-6, "python": 30e-6})
    cat = Catalog()
    # the untraced window: 4 units in 400 us, 100 us a unit
    window = Window(units=4, problems_per_unit=1, wall_s=4e-4,
                    intervals_ms=[0.1] * 4)
    run = harness.Run(setup_s=1.0, window=window, trace=tr,
                      work={"flops": 67e12 * 3e-6, "bytes": 0.0})
    assert cat.reader("host_syncs.cn")(run) == 0.5
    assert cat.reader("kernel_launches.cn")(run) == 1.0
    assert cat.reader("step_roofline.cn")(run) == pytest.approx(20.0)
    # 20 us busy a unit against 100 us a unit untraced
    assert cat.reader("idle_share.cn")(run) == pytest.approx(0.8)
    silent = harness.Run(setup_s=1.0, window=window, trace=None, work={})
    for m in ("host_syncs.cn", "kernel_launches.cn", "step_roofline.cn",
              "idle_share.cn"):
        assert cat.reader(m)(silent) is None


def test_cli_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "heat_cn_d12_r64.stream", "--seed", str(SEED),
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""

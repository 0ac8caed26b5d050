"""A cell on several cards, as ranks under torchrun (``bench_ranks``), on
the CPU: gloo ranks at test size.  The four-card cell runs on two ranks:
its result, a job that raises on one rank, a rank that dies in the
window, the faults its check must catch, and the one-card path left as
it was."""

import json
import os
import subprocess
import sys
import time

import pytest

import bench_ranks
from bench_harness import run_cell
from conftest import BENCH, ROOT, tiny

CELL = "grch38_chr20.map_mesh4"
# the one-card map cell's readers of rank 0's spans and counters, which
# read the same layers on the mesh
RANK0_SPANS = ("parse_share.map", "index_share.map", "chain_share.map",
               "unnamed_share.map", "parse_rate.map")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]

# Planted in every rank (LOCAL_RANK set) at its start, as sitecustomize,
# by the fault named in PORTBENCH_TEST_FAULT.
PLANT = '''
import os
FAULT = os.environ.get("PORTBENCH_TEST_FAULT")
if FAULT and "LOCAL_RANK" in os.environ:
    import numpy as np
    from modimizer_tpu_torch.cli import modmap
    from modimizer_tpu_torch.parallel import lookup, mesh
    RANK = int(os.environ["RANK"])
    lookup_orig, emit_orig, calls = modmap._lookup, modmap.emit, [0]
    if FAULT == "exchange_left_out":           # each rank keeps its sends
        mesh.Mesh.all_to_all = lambda self, x: x
    elif FAULT == "state_unchanged":           # no answer leaves its zero
        lookup.DeviceTable._find = lambda self, q: np.zeros(len(q), np.uint32)
    elif FAULT == "half_the_queries" and RANK == 0:
        def half(ref, batch, rid, rpos, sidx, *a):
            return emit_orig(ref, batch, rid[::2], rpos[::2], sidx[::2], *a)
        modmap.emit = half
    elif FAULT == "answer_altered" and RANK == 0:
        def off(ref, sc, km, mesh=None):
            out = np.array(lookup_orig(ref, sc, km, mesh))
            out[len(out) // 2] = (out[len(out) // 2] % ref.ms.max) + 1
            return out
        modmap._lookup = off
    elif FAULT == "raises" and RANK == 1:      # after the job's collectives
        def boom(*a, **k):
            lookup_orig(*a, **k)
            raise RuntimeError("planted on rank 1")
        modmap._lookup = boom
    elif FAULT == "hangs" and RANK == 1:       # in the warm-up job
        def stuck(*a, **k):
            import time
            time.sleep(3600)
        modmap._lookup = stuck
    elif FAULT == "jax_loaded" and RANK == 1:  # in a job, on rank 1 alone
        def loads(*a, **k):
            import sys
            import types
            sys.modules.setdefault("jax", types.ModuleType("jax"))
            return lookup_orig(*a, **k)
        modmap._lookup = loads
    elif FAULT == "exits" and RANK == 1:       # in the window's first job
        def gone(*a, **k):
            calls[0] += 1
            if calls[0] == 2:
                os._exit(7)
            return lookup_orig(*a, **k)
        modmap._lookup = gone
'''


@pytest.fixture
def plant(tmp_path, monkeypatch):
    """Sets the fault the ranks plant at their start."""
    (tmp_path / "sitecustomize.py").write_text(PLANT)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(tmp_path), ROOT]))

    def set_fault(name):
        monkeypatch.setenv("PORTBENCH_TEST_FAULT", name)
    return set_fault


@pytest.fixture(autouse=True)
def threads(monkeypatch):
    """Four threads a rank: torchrun's one makes the CPU versions of the
    scan kernels slow (the card runs them in CUDA)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "4")


def launch_tiny(spec, seed, trace=False, seconds=0.01):
    cfg = tiny(spec.config(spec.cell(CELL)))
    return bench_ranks.launch(spec, CELL, seed, seconds, trace,
                              time.perf_counter(), device="cpu", cfg=cfg,
                              nproc=2)


def leftovers(seed):
    """Processes of this machine whose command line holds ``--seed
    <seed>``: a launch's agent and ranks."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open("/proc/%s/cmdline" % pid, "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"--seed" in argv and str(seed).encode() in argv:
            found.append(int(pid))
    return found


@pytest.mark.parametrize("trace", [False, True])
def test_the_mesh_cell_is_correct_on_two_ranks(spec, trace):
    seed = 2 ** 31 + 101 + trace
    rc, r = launch_tiny(spec, seed, trace)
    assert rc == 0 and r is not None
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] == 0 for c in r["checks"].values()), r["checks"]
    cell = spec.cell(CELL)
    want = {m["name"] for m in spec.metrics(
        "per_layer" if trace else "end_to_end", cell)}
    if trace:
        # no card: the device-trace readers find nothing and are left out
        assert set(r["metrics"]) == {"lookup_share.map_mesh4",
                                     "idle_share.map"} | set(RANK0_SPANS)
        for name in ("lookup_share.map_mesh4",) + RANK0_SPANS:
            assert r["metrics"][name]["value"] > 0, name
        for name in ("lookup_share.map_mesh4",) + RANK0_SPANS[:4]:
            assert r["metrics"][name]["value"] < 100, name
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert set(r["metrics"]) == want == {"map_rate", "setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["device"]["count"] == cell["chips"]
    assert not leftovers(seed)


def test_a_job_that_raises_on_one_rank_is_a_failed_job(spec, plant):
    plant("raises")
    rc, r = launch_tiny(spec, 2 ** 31 + 111)
    assert rc == 0 and r is not None
    assert r["correct"] is False
    assert r["checks"]["jobs_failed"]["value"] >= 1
    assert r["failed"] == r["checks"]["jobs_failed"]["value"]


def test_jax_loaded_on_a_rank_above_0_gives_no_result(spec, plant):
    plant("jax_loaded")
    seed = 2 ** 31 + 115
    rc, r = launch_tiny(spec, seed)
    assert rc != 0 and r is None
    time.sleep(0.5)
    assert not leftovers(seed)


def test_a_rank_that_dies_ends_the_run_with_no_result(spec, plant):
    plant("exits")
    seed = 2 ** 31 + 121
    t0 = time.monotonic()
    rc, r = launch_tiny(spec, seed, seconds=30.0)
    took = time.monotonic() - t0
    assert rc != 0 and r is None
    assert took < bench_ranks.GROUP_TIMEOUT_S + bench_ranks.TERM_GRACE_S
    time.sleep(0.5)
    assert not leftovers(seed)


def test_a_rank_that_hangs_is_stopped_at_the_deadline(spec, plant,
                                                      monkeypatch):
    plant("hangs")
    monkeypatch.setattr(bench_ranks, "DEADLINE_S", 20)
    seed = 2 ** 31 + 125
    t0 = time.monotonic()
    rc, r = launch_tiny(spec, seed)
    took = time.monotonic() - t0
    assert rc == 124 and r is None
    assert took < 20 + bench_ranks.TERM_GRACE_S
    time.sleep(0.5)
    assert not leftovers(seed)


@pytest.mark.parametrize("fault", ["exchange_left_out", "state_unchanged",
                                   "half_the_queries", "answer_altered"])
def test_a_broken_mesh_is_not_correct(spec, plant, fault):
    plant(fault)
    rc, r = launch_tiny(spec, 2 ** 31 + 131)
    assert rc == 0 and r is not None
    assert r["correct"] is False
    assert r["checks"]["lookups_wrong"]["value"] > 0 or \
        r["checks"]["lines_wrong"]["value"] > 0


def test_a_one_card_cell_runs_in_this_process_with_no_group(spec):
    import torch.distributed as dist
    cell = "grch38_chr20.map"
    r = run_cell(spec, cell, 2 ** 31 + 141, 0.01, False, "cpu",
                 time.perf_counter(), cfg=tiny(spec.config(spec.cell(cell))),
                 say=lambda _s: None)
    assert list(r) == KEYS + ["checks"] and r["correct"] is True
    assert not dist.is_initialized()


@pytest.mark.parametrize("cell,launched", [("grch38_chr20.map", False),
                                           ("ecoli_hifi30x.build", False),
                                           (CELL, True)])
def test_run_launches_ranks_only_for_a_cell_on_several_cards(
        monkeypatch, cell, launched):
    """run.py's dispatch, with the card's presence faked and both paths
    replaced by recorders."""
    import importlib.util
    import torch
    import bench_harness
    calls = []
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "checks": {}}

    def fake_run_cell(*a, **k):
        calls.append(("run_cell", k))
        return result

    def fake_launch(*a, **k):
        calls.append(("launch", k))
        return 0, result
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(bench_harness, "run_cell", fake_run_cell)
    monkeypatch.setattr(bench_ranks, "launch", fake_launch)
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    spec_ = importlib.util.spec_from_file_location(
        "portbench_run", os.path.join(BENCH, "run.py"))
    run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(run)
    assert run.main(["--workload", cell, "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 0
    assert [c[0] for c in calls] == ["launch" if launched else "run_cell"]
    assert calls[0][1] == {}          # the one-card call as it was
    # one card: OpenMP at run.SOLO_THREADS; several: torchrun's default
    assert os.environ.get("OMP_NUM_THREADS") == (
        None if launched else str(run.SOLO_THREADS))


def test_run_keeps_the_environments_openmp_threads(monkeypatch):
    import importlib.util
    import torch
    import bench_harness
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench_harness, "run_cell", lambda *a, **k: {
        "correct": True, "attempted": 1, "failed": 0, "metrics": {},
        "device": {}, "checks": {}})
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    spec_ = importlib.util.spec_from_file_location(
        "portbench_run", os.path.join(BENCH, "run.py"))
    run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(run)
    assert run.main(["--workload", "ecoli_hifi30x.build", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 0
    assert os.environ["OMP_NUM_THREADS"] == "3"


def test_without_cards_enough_the_command_prints_no_result():
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has four CUDA cards")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          CELL, "--seed", "1", "--seconds", "1", "--trace",
                          "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_the_lockstep_over_one_store():
    """Two ranks' ``Ranks`` on one store: rank 0 decides each job, sees
    every rank's failure, and gathers every rank's readings."""
    from torch.distributed import HashStore
    store = HashStore()
    lead = bench_ranks.Ranks(store, 0, 2)
    other = bench_ranks.Ranks(store, 1, 2)
    assert lead.go(True) and other.go(False)
    assert other.done("Traceback: boom") is None
    assert lead.done(None) == "rank 1: Traceback: boom"
    assert not lead.go(False) and not other.go(True)
    other.done(None)
    assert lead.done(None) is None
    other.put("peak", 7)
    assert lead.gather("peak", 5) == [5, 7]


def test_route_bytes_are_the_probes(spec):
    from bench_roofline import route_bytes
    from modimizer_tpu_torch.probes.probe_route import route_bytes as probe
    for N, n, cap in ((967_742, 4, 241_936), (10, 2, 5), (0, 4, 0)):
        for mode in ("lookup", "builder"):
            assert route_bytes(N, n, cap, mode) == probe(N, n, cap, mode)
    # lookup mode: the queries in at 8 B, the slots out at 4 B, the counts
    assert route_bytes(250, 4, 250, "lookup") == 250 * 8 + 1000 * 4 + 16


def test_the_mesh_readers(spec):
    from bench_roofline import HBM_BYTES_S, route_bytes
    from bench_trace import Window
    sizes = {"queries": 6_000_001}
    dev = [("void route_tiles<1, true>(long const*)", 0, 300),
           ("route_pad(int, int const*)", 300, 400),
           ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
            1_000, 3_000),
           ("ncclDevKernel_AllGather_RING_LL(x)", 2_000, 4_000),
           ("find_sorted_kernel(long const*)", 5_000, 6_000)]
    w = Window(10.0, 3, [], sizes, (0, 10_000_000), dev, ranks=4)
    got = spec.reader("route_roofline.map_mesh4")(w)
    want = 3 * route_bytes(1_500_001, 4, 1_500_001, "lookup")
    assert got == pytest.approx(100 * want / HBM_BYTES_S / 400e-6)
    assert spec.reader("collective_share.map_mesh4")(w) == \
        pytest.approx(100 * 3_000e-6 / 10.0)


@pytest.mark.parametrize("name", ["lookup_share.map_mesh4",
                                  "collective_share.map_mesh4",
                                  "route_roofline.map_mesh4"])
def test_a_mesh_reader_with_nothing_to_read_returns_nothing(spec, name):
    from bench_trace import Window
    empty = Window(10.0, 0, [], {"queries": 100}, (0, 1_000_000), [],
                   ranks=4)
    assert spec.reader(name)(empty) is None


def test_the_benchmark_has_one_cell_on_four_cards(spec):
    cells = spec.bench["workloads"]
    assert [c["name"] for c in cells if c["chips"] > 1] == [CELL]
    for m in ("map_rate", "idle_share.map", "lookup_share.map_mesh4",
              "collective_share.map_mesh4", "route_roofline.map_mesh4",
              "scan_roofline.map") + RANK0_SPANS:
        entry = [e for k in ("end_to_end", "per_layer")
                 for e in spec.bench[k] if e["name"] == m][0]
        assert CELL in entry["workloads"]
    lookup = [e for e in spec.bench["per_layer"]
              if e["name"] == "lookup_roofline.map"][0]
    assert CELL not in lookup["workloads"]
    traffic = json.loads(open(os.path.join(
        BENCH, "traffic", "map_mesh4.json")).read())
    base = json.loads(open(os.path.join(BENCH, "traffic", "map.json")).read())
    assert {k: v for k, v in traffic.items() if k != "why"} == \
        {k: v for k, v in base.items() if k != "why"}

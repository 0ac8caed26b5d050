"""The harness on the CPU at test size: the result line, the import
check, a cell and a metric added as files alone, and the output check
failing on a broken program."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from bench_harness import Spec, banned_modules, job_argv, run_cell
from conftest import BENCH, ROOT, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(spec, cell, trace=False, seed=2 ** 31 + 11, **sizes):
    cfg = tiny(spec.config(spec.cell(cell)), **sizes)
    return run_cell(spec, cell, seed, 0.01, trace, "cpu",
                    time.perf_counter(), cfg=cfg, say=lambda _s: None)


@pytest.mark.parametrize("cell", ["ecoli_hifi30x.build", "grch38_chr20.map"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(spec, cell, trace):
    r = run_tiny(spec, cell, trace)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    json.dumps(r)
    want = {m["name"] for m in spec.metrics(
        "per_layer" if trace else "end_to_end", spec.cell(cell))}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_argv_templates_fill_from_the_config():
    t = {"argv": ["-c", "{b}", "-s", "{th}", "-a", "{reads}"]}
    assert job_argv(t, {"b": 24, "th": [10, 45, 75], "reads": "x.fa"}) == \
        ["-c", "24", "-s", "10", "45", "75", "-a", "x.fa"]


def test_import_check_compares_whole_top_level_names(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "modimizer_tpu_torch_x",
                        types.ModuleType("modimizer_tpu_torch_x"))
    monkeypatch.setitem(sys.modules, "jaxfoo", types.ModuleType("jaxfoo"))
    before = banned_modules()
    assert "modimizer_tpu_torch" not in before
    monkeypatch.setitem(sys.modules, "modimizer_tpu.cli.x",
                        types.ModuleType("modimizer_tpu.cli.x"))
    assert "modimizer_tpu" in banned_modules()


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path[:0] = [%r, %r]\n"
            "from bench_harness import Spec, run_cell, banned_modules\n"
            "from conftest import tiny\n"
            "s = Spec(%r)\n"
            "c = tiny(s.config(s.cell('grch38_chr20.map')))\n"
            "r = run_cell(s, 'grch38_chr20.map', 5, 0.01, True, 'cpu',"
            " time.perf_counter(), cfg=c, say=lambda _s: None)\n"
            "assert r['correct'], r\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % (BENCH, os.path.join(BENCH, "tests"),
               os.path.join(ROOT, "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "modimizer_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "modimizer_tpu"}


def imports_of(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_and_checks_import_nothing_of_the_program():
    files = list(Path(BENCH, "reference").glob("*.py")) + \
        list(Path(BENCH, "checks").glob("*.py"))
    for f in files:
        for name in imports_of(f):
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "flax", "modimizer_tpu",
                "modimizer_tpu_torch", "bench_harness"), (f, name)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import numpy as np\n"
            "from reference import build_ref, map_ref\n"
            "import checks.build, checks.map, control\n"
            "rng = np.random.default_rng(1)\n"
            "g = rng.integers(0, 4, 5000).astype(np.uint8)\n"
            "r = rng.integers(0, 4, (20, 500)).astype(np.uint8)\n"
            "cfg = dict(k=19, w=31, hash_seed=17, table_bits=24,"
            " copy_thresholds=[1, 2, 3], genome_name='g')\n"
            "build_ref.build(r, cfg, 'cpu')\n"
            "map_ref.modmap(g, r, cfg, 'cpu')\n"
            "bad = {m.split('.')[0] for m in sys.modules} & {'jax', 'flax',"
            " 'jaxlib', 'modimizer_tpu', 'modimizer_tpu_torch'}\n"
            "assert not bad, bad\n" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]


def test_nothing_in_portbench_imports_jax_or_the_jax_package():
    for f in Path(BENCH).rglob("*.py"):
        for name in imports_of(f):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "modimizer_tpu"), (f, name)


def test_a_cell_and_a_metric_are_files_alone(tmp_path):
    """A copy of the benchmark with a new configuration, a new traffic
    mix and a new per-layer metric, each a new file, and new entries in
    BENCHMARK.json: no file already there changes."""
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "_cache", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "ecoli_hifi30x.json").read_text())
    cfg.update(name="ecoli_hifi5x", genome_len=30_000, n_reads=30,
               read_len=1_500, k=21, w=15, copy_thresholds=[2, 4, 6])
    (bench / "configs" / "ecoli_hifi5x.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "build.json").read_text())
    traffic["why"] = "the same jobs under another name"
    (bench / "traffic" / "build_nocopy.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "jobs_seen.build.py").write_text(
        "def read(w):\n    return float(w.jobs)\n")
    spec = json.loads(Path(ROOT, "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "ecoli_hifi5x.build_nocopy",
                              "config": "ecoli_hifi5x",
                              "traffic": "build_nocopy", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "build_rate":
            m["workloads"].append("ecoli_hifi5x.build_nocopy")
    spec["per_layer"].append({"name": "jobs_seen.build", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "parse", "moves": "build_rate",
                              "workloads": ["ecoli_hifi5x.build_nocopy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    s = Spec(tmp_path / "BENCHMARK.json", bench)
    for trace in (False, True):
        r = run_cell(s, "ecoli_hifi5x.build_nocopy", 9, 0.01, trace, "cpu",
                     time.perf_counter(), say=lambda _s: None)
        assert r["correct"], r
    assert r["metrics"]["jobs_seen.build"]["value"] >= 1
    for p, b in before.items():
        assert p.read_bytes() == b, p


# -- a broken program must read as not correct -------------------------

def fault(monkeypatch, name):
    from modimizer_tpu_torch.cli import modmap, modutils
    from modimizer_tpu_torch.core.modset import Modset
    from modimizer_tpu_torch.parallel import sharded
    # the build takes the card's counting path (the builder) at test size
    monkeypatch.setattr(modutils, "DEVICE_COUNT_THRESHOLD", 1)
    if name == "state_unchanged":          # the table replay does nothing
        monkeypatch.setattr(Modset, "add_batch",
                            lambda self, *a, **k: None)
    elif name == "half_the_rows":          # the counted rows, half left out
        fin = sharded.ShardedModsetBuilder.finalize

        def half(self):
            u, c = fin(self)
            return u[::2], c[::2]
        monkeypatch.setattr(sharded.ShardedModsetBuilder, "finalize", half)
    elif name == "count_altered":          # one count off by one
        fin = sharded.ShardedModsetBuilder.finalize

        def off(self):
            u, c = fin(self)
            c = np.array(c)
            c[len(c) // 2] += 1
            return u, c
        monkeypatch.setattr(sharded.ShardedModsetBuilder, "finalize", off)
    elif name == "no_lookup":              # answers left at their zeros
        monkeypatch.setattr(modmap, "_lookup", lambda ref, sc, km, mesh=None:
                            np.zeros(len(km), np.uint32))
    elif name == "half_the_queries":       # every other query row dropped
        orig = modmap.emit

        def half(ref, batch, rid, rpos, sidx, *a):
            return orig(ref, batch, rid[::2], rpos[::2], sidx[::2], *a)
        monkeypatch.setattr(modmap, "emit", half)
    elif name == "answer_altered":         # one lookup answer changed
        orig = modmap._lookup

        def off(ref, sc, km, mesh=None):
            out = np.array(orig(ref, sc, km, mesh))
            out[len(out) // 2] = (out[len(out) // 2] % ref.ms.max) + 1
            return out
        monkeypatch.setattr(modmap, "_lookup", off)


@pytest.mark.parametrize("cell,name", [
    ("ecoli_hifi30x.build", "state_unchanged"),
    ("ecoli_hifi30x.build", "half_the_rows"),
    ("ecoli_hifi30x.build", "count_altered"),
    ("grch38_chr20.map", "no_lookup"),
    ("grch38_chr20.map", "half_the_queries"),
    ("grch38_chr20.map", "answer_altered")])
def test_a_broken_program_is_not_correct(spec, monkeypatch, cell, name):
    fault(monkeypatch, name)
    r = run_tiny(spec, cell)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_builder_path_itself_is_correct(spec, monkeypatch):
    from modimizer_tpu_torch.cli import modutils
    monkeypatch.setattr(modutils, "DEVICE_COUNT_THRESHOLD", 1)
    assert run_tiny(spec, "ecoli_hifi30x.build")["correct"] is True


def test_without_a_card_the_command_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "ecoli_hifi30x.build", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: the port is
    missing, so the run fails before any result."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(Path(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "ecoli_hifi30x.build", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and '"correct"' not in out.stdout

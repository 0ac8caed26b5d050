"""The port's probe entry points (modimizer_tpu_torch/probes/) on the CPU:
each ``main(argv, device="cpu")`` holds its kernels' wrappers against their
plain versions and prints one JSON line per variant; names of TPU-only
backends exit non-zero; no probe imports jax.  On the card the same entry
points time the kernels (chip_smoke.py, phase ``probes``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from modimizer_tpu_torch.probes import (probe_chain, probe_chain_time,
                                        probe_densify, probe_front,
                                        probe_front_mxu, probe_minimizer,
                                        probe_pallas_front,
                                        probe_pallas_parts, probe_route,
                                        probe_scan_compact)

REPO = Path(__file__).resolve().parent.parent
MJ = "256"

RUNS = [
    (probe_pallas_parts, ["14", MJ],
     ["full", "noin", "noout", "kmonly", "emonly"]),
    (probe_pallas_parts, ["14", MJ, "noout,full"], ["noout", "full"]),
    (probe_pallas_front, ["14", MJ], ["count", "planes", "front32"]),
    (probe_front_mxu, ["14", MJ], ["nohash", "mul16", "mxu"]),
    (probe_chain_time, ["14", "1", "2", "--mj", MJ],
     ["front", "nohash", "front_xla", "fusedd_pm"]),
    (probe_front, [], ["copy", "static16", "dyn", "mul10", "iota"]),
    (probe_front, ["mul10", "iota"], ["mul10", "iota"]),
]


@pytest.mark.parametrize("mod,argv,want", RUNS,
                         ids=[m.__name__.rsplit(".", 1)[1] + "-" + "-".join(a)
                              for m, a, _w in RUNS])
def test_probe_runs_on_cpu(capsys, mod, argv, want):
    assert mod.main(argv, device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["variant"] for x in lines] == want
    for x in lines:
        assert x["check"] in ("match", "is the plain version")
        assert x["device"] == "cpu" and x["ms"] is None
        assert x["card"] is None


@pytest.mark.parametrize("argv,shapes", [
    (["--small"], ["scanner", "u64", "builder", "noemit"]),
    (["--small", "u64"], ["u64"])])
def test_probe_scan_compact_runs_on_cpu(capsys, argv, shapes):
    assert probe_scan_compact.main(argv, device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["shape"] for x in lines] == shapes
    for x in lines:
        # a k-mers-only shape also checks the kernel storing its meta
        want = ["current"] + ([] if x["with_meta"] else ["current_meta"])
        assert x["check"] == dict.fromkeys(want, "match")
        assert x["C"] == 1 << 15
        assert x["with_meta"] == (x["shape"] == "builder")
        assert x["device"] == "cpu" and x["ms"] is None


@pytest.mark.parametrize("argv", [["bogus"], ["--baseline", "old.cu"]])
def test_probe_scan_compact_bad_arguments_exit_nonzero(argv):
    with pytest.raises(SystemExit) as e:
        probe_scan_compact.main(argv + ["--small"], device="cpu")
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("argv,shapes", [
    (["--small"], ["scanner", "u64", "meta"]),
    (["--small", "meta"], ["meta"])])
def test_probe_densify_runs_on_cpu(capsys, argv, shapes):
    assert probe_densify.main(argv, device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["shape"] for x in lines] == shapes
    for x in lines:
        assert x["check"] == {"current": "match"}
        assert x["C"] == 1 << 15 and 0 < x["live_rows"] <= x["cap"]
        assert x["with_meta"] == (x["shape"] == "meta")
        assert x["device"] == "cpu" and x["ms"] is None


@pytest.mark.parametrize("argv", [["bogus"], ["--baseline", "old.cu"]])
def test_probe_densify_bad_arguments_exit_nonzero(argv):
    with pytest.raises(SystemExit) as e:
        probe_densify.main(argv + ["--small"], device="cpu")
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("argv,shapes", [
    (["--small"], [("merge", 1), ("merge", 2), ("merge", 4), ("merge", 8),
                   ("builder", 1), ("lookup", 1)]),
    (["--small", "lookup"], [("lookup", 1)])])
def test_probe_route_runs_on_cpu(capsys, argv, shapes):
    assert probe_route.main(argv, device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["shape"], x["n"]) for x in lines] == shapes
    for x in lines:
        # the kernel's wrapper (its plain version here) and the library
        # route against route_rows_ref
        assert x["check"] == {"current": "match", "library": "match"}
        assert x["rows"] > 0 and x["cap"] >= x["rows"] / x["n"]
        assert x["device"] == "cpu" and x["ms"] is None


@pytest.mark.parametrize("argv", [["bogus"], ["--baseline", "old.cu"]])
def test_probe_route_bad_arguments_exit_nonzero(argv):
    with pytest.raises(SystemExit) as e:
        probe_route.main(argv + ["--small"], device="cpu")
    assert e.value.code not in (0, None)


def test_probe_minimizer_runs_on_cpu(capsys):
    assert probe_minimizer.main(["--small"], device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["shape"] for x in lines] == list(probe_minimizer.SHAPES)
    for x in lines:
        assert x["check"] == {"current": "match"}
        assert x["path"] == ("tile" if x["w"] <= 1024 else "wide")
        assert x["positions"] >= 1 << 15 and x["ms"] is None


def test_probe_chain_runs_on_cpu(capsys):
    assert probe_chain.main(["--small"], device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["shape"] for x in lines] == list(probe_chain.SHAPES)
    bench, longest, copy = lines
    assert bench["check"] == longest["check"] == {"current": "match"}
    assert bench["reads"] == 10_000 and bench["records"] > 10_000
    assert (bench["records"] <= bench["block_openings"]
            <= bench["live_seeds"] < bench["seeds"])
    assert longest["reads"] == 1 and copy["check"] == "is a copy"
    assert all(x["ms"] is None and x["device"] == "cpu" for x in lines)


def literal_loads(ref, sidx, seed_off):
    """Block openings and copy-2 retries of modmap.c:216-280, seed by seed
    (the reference's queryProcess, as tests/test_torch_chain.py's oracle
    transcribes it)."""
    info = ref.ms.info
    opens = retries = 0
    for rd in range(len(seed_off) - 1):
        loc0 = locN = i0 = iN = 0
        for t in range(seed_off[rd], seed_off[rd + 1]):
            idx = sidx[t]
            if idx == 0 or (info[idx] & 3) == 3:
                continue
            loc = int(ref.rev[ref.loc[idx]])

            def end_block(loc):
                if ref.id[loc] != ref.id[loc0]:
                    return True
                if loc0 < locN:
                    d = locN - loc0 - iN + i0
                    return loc < locN or d > 50 or d < -50
                if loc0 > locN:
                    d = loc0 - locN - iN + i0
                    return loc > locN or d > 50 or d < -50
                return False
            end = loc0 == 0 or end_block(loc)
            if end and loc0 and (info[idx] & 3) != 1:
                retries += 1
                loc = int(ref.rev[ref.loc[idx] + 1])
                end = end_block(loc)
            if end:
                opens += 1
                loc0, i0 = loc, t - seed_off[rd]
            locN, iN = loc, t - seed_off[rd]
    return opens, retries


def test_probe_chain_block_loads_equal_a_literal_count():
    """The bound's data-dependent loads (block_loads, the automaton over
    every read at once) against the reference's loop, seed by seed."""
    from modimizer_tpu_torch.parallel import chain as ch
    ref, sidx, spos, off = probe_chain.bench_chain_case(400, 30)
    la, lb, ia, ib, is1, live, _ps = ch.seed_planes(ref, sidx, spos)
    got = probe_chain.block_loads(la, lb, ia, ib, is1, live, ref.id, off)
    assert got == literal_loads(ref, sidx, off)
    assert got[0] > 400 and got[1] > 0


@pytest.mark.parametrize("mod,argv", [
    (probe_minimizer, ["bogus"]), (probe_minimizer, ["--part"]),
    (probe_minimizer, ["--baseline", "old.cu"]),
    (probe_chain, ["bogus"]), (probe_chain, ["--part"]),
    (probe_chain, ["--baseline", "old.cu"])])
def test_probe_minimizer_chain_bad_arguments_exit_nonzero(mod, argv):
    with pytest.raises(SystemExit) as e:
        mod.main(argv + ["--small"], device="cpu")
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("name", probe_chain_time.UNPORTED)
def test_tpu_only_backend_exits_nonzero(name):
    with pytest.raises(SystemExit) as e:
        probe_chain_time.main(["14", "1", "2", "front," + name, "--mj", MJ],
                              device="cpu")
    assert e.value.code not in (0, None)
    assert "Do not port the losing TPU-only backends" in str(e.value.code)


@pytest.mark.parametrize("mod,argv", [
    (probe_pallas_parts, ["14", MJ, "full,bogus"]),
    (probe_front_mxu, ["14", MJ, "mxu2"]),
    (probe_front, ["rot"]),
    (probe_pallas_parts, ["14", "4096"]),
    (probe_pallas_parts, ["14", MJ, "noout", "--baseline", "old.cu"]),
    (probe_pallas_front, ["14", MJ, "--baseline", "old.cu"])])
def test_bad_arguments_exit_nonzero(mod, argv):
    with pytest.raises(SystemExit) as e:
        mod.main(argv, device="cpu")
    assert e.value.code not in (0, None)


def test_card_required_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("checks the policy of a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_pallas_parts.main(["14", MJ], device=None)


_NO_JAX = r"""
import runpy, sys
sys.argv = ["probe_pallas_parts", "--help"]
try:
    runpy.run_module("modimizer_tpu_torch.probes.probe_pallas_parts",
                     run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert "jax" not in sys.modules, "jax was imported"
from modimizer_tpu_torch.probes import (probe_chain_time, probe_densify,
                                        probe_front, probe_front_mxu,
                                        probe_pallas_front)
assert probe_chain_time.main(["12", "1", "1", "--mj", "128"],
                             device="cpu") == 0
assert "jax" not in sys.modules, "jax was imported"
sys.stderr.write("NO_JAX_OK\n")
"""


def test_probes_never_import_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stderr
    assert "usage: probe_pallas_parts" in r.stdout


_SASS = """
\tcode for sm_90a
\t\tFunction : _Z3fooPj
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
    /*0000*/   LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */
                                 /* 0x000fe20000000800 */
    /*0010*/   S2R R0, SR_TID.X ;  /* 0x0000000000007919 */
.L_x_1:
    /*0020*/   IMAD.HI.U32 R2, R0, R3, RZ ;  /* 0x0000000300027227 */
    /*0030*/   IMAD R2, R0, R3, R2 ;  /* 0x0000000300027224 */
    /*0040*/   SHF.L.U32 R4, R2, 0x2, RZ ;  /* 0x0000000202047819 */
    /*0050*/   @P0 BRA `(.L_x_1) ;  /* 0xfffffffc00000947 */
    /*0060*/   EXIT ;  /* 0x000000000000794d */
.L_x_2:
    /*0070*/   BRA `(.L_x_2);  /* 0xfffffffc00fc7947 */
    /*0080*/   NOP;  /* 0x0000000000007918 */
"""
_PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPj' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, 352 bytes cmem[0]
"""


def test_sass_count_parses_loops():
    from modimizer_tpu_torch.probes import sass_count
    kernels, labels = sass_count.parse(_SASS)
    insns = kernels["_Z3fooPj"]
    assert [o for _a, o, _t in insns] == [
        "LDC", "S2R", "IMAD.HI", "IMAD", "SHF", "BRA", "EXIT", "BRA", "NOP"]
    (start, end, ops), = sass_count.loops(insns, labels["_Z3fooPj"])
    assert (start, end) == (0x20, 0x50)
    assert ops == ["IMAD.HI", "IMAD", "SHF", "BRA"]
    # a cubin's listing names branch targets by address
    kernels, labels = sass_count.parse(_SASS.replace("`(.L_x_1)", "0x20"))
    (start, end, _ops), = sass_count.loops(kernels["_Z3fooPj"], {})
    assert (start, end) == (0x20, 0x50)
    info = sass_count.ptxas_info(_PTXAS)
    assert info["_Z3fooPj"][-1] == "Used 12 registers, 352 bytes cmem[0]"
    assert "0 bytes spill stores" in info["_Z3fooPj"][1]

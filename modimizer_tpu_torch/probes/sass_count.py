"""Instruction counts of a CUDA source's kernels, from their SASS: what
ptxas reports (registers, shared memory, spills), each kernel's
instructions, and each loop's body (the instructions from a backward
branch's target to the branch) with its opcode mix.  The source is compiled
with the port's nvcc flags into ``_build/`` beside it, and disassembled
with the toolkit's ``cuobjdump``.  One JSON line per kernel::

    python -m modimizer_tpu_torch.probes.sass_count \\
        modimizer_tpu_torch/csrc/front_reduce.cu

Needs the CUDA toolkit (the card's machine), not the card.
"""

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

from .. import _build

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def opcode(text: str) -> str:
    """The instruction's opcode without its predicate and modifiers; IMAD
    keeps .HI and .WIDE, which differ in cost."""
    words = text.split()
    op = words[1] if words[0].startswith("@") else words[0]
    base = op.split(".")[0]
    if base == "IMAD":
        for mod in (".HI", ".WIDE"):
            if mod in op:
                return base + mod
    return base


def parse(sass: str):
    """{kernel: [(address, opcode, text)]} and {kernel: {label: address}}
    from cuobjdump -sass output."""
    kernels, labels, name, pending = {}, {}, None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            kernels[name].append((addr, opcode(m.group(2)), m.group(2)))
    return kernels, labels


def loops(insns, labels):
    """Each backward branch's body: (start, end, [opcodes]), innermost
    first (shortest).  A branch names its target by a label or (in a
    cubin's listing) by its address."""
    out = []
    for addr, op, text in insns:
        m = _TARGET.search(text) if op == "BRA" else None
        if not m:
            continue
        start = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if start is not None and start < addr:
            out.append((start, addr, [o for a, o, _t in insns
                                      if start <= a <= addr]))
    return sorted(out, key=lambda x: x[1] - x[0])


def ptxas_info(text: str):
    """{kernel: ptxas -v's lines about it} (registers, shared memory, stack
    and spills follow its 'Compiling entry function' line)."""
    info, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            info[name] = []
        elif name is not None and line.strip():
            info[name].append(re.sub(r"^ptxas info\s*:\s*", "",
                                     line.strip()))
    return info


def count(src):
    src = Path(src).resolve()
    out_dir = src.parent / "_build"
    out_dir.mkdir(exist_ok=True)
    cubin = out_dir / (src.stem + ".cubin")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    nvcc = _build._nvcc()
    r = subprocess.run([nvcc] + flags + ["-cubin", "-Xptxas", "-v", "-o",
                                         str(cubin), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit("nvcc failed:\n" + r.stdout + r.stderr)
    ptxas = ptxas_info(r.stdout + r.stderr)
    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    kernels, labels = parse(dump)
    lines = []
    for name, insns in kernels.items():
        body = [o for _a, o, _t in insns if o != "NOP"]
        lines.append({
            "kernel": name, "instructions": len(body),
            "mix": dict(collections.Counter(body).most_common()),
            "loops": [{"start": hex(a), "end": hex(b),
                       "instructions": len([o for o in ops if o != "NOP"]),
                       "mix": dict(collections.Counter(
                           o for o in ops if o != "NOP").most_common())}
                      for a, b, ops in loops(insns, labels[name])],
            "ptxas": ptxas.get(name, [])})
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sass_count",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("source")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for line in count(a.source):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Count the SASS instructions of a kernel's loops in the built library.

    python scripts/sass_loops.py KERNEL_SUBSTRING [--root DIR] [--opcode OP]

Runs ``cuobjdump -sass`` on the kernel library of ``tpufluid_torch`` (of
this checkout, or of the checkout at DIR; built first if needed; needs the
CUDA toolkit), takes the functions whose mangled name contains
KERNEL_SUBSTRING, and lists every loop: a backward branch and the
instructions from its target to it. For each loop it prints the
instruction count, how many of them are OP (by default ``MUFU.EX2``, the
exp2 unit that ``expf`` ends in) and the counts of the most frequent
opcodes. The innermost loop that holds one is marked: for the metaball
coarse kernel that is the pair loop, one candidate against the samples a
thread holds; for sph_density (``--opcode FMUL``) the pair loop, and for
sph_forces (``--opcode MUFU.RSQ``, the sqrt) its pair loop's in-range
body.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

OPCODE = "MUFU.EX2"
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")


def functions(sass: str):
    """{mangled name: ([(address, opcode, operands)], {label: address})}"""
    out, name, pending = {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = ([], {})
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            out[name][0].append((addr, m.group(3), m.group(4).strip()))
            for label in pending:
                out[name][1][label] = addr
            pending = []
    return out


def loops(insns, labels):
    """(start address, end address) of every backward branch."""
    found = []
    for addr, op, args in insns:
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", args)
            l = re.search(r"\.L_x_\d+", args)
            target = (int(m.group(1), 16) if m
                      else labels.get(l.group(0)) if l else None)
            if target is not None and target <= addr:
                found.append((target, addr))
    return found


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--opcode", default=OPCODE)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from tpufluid_torch import _build

    want, opcode = args.kernel, args.opcode
    _build.load()
    lib = _build.build_dir() / _build.LIB_NAME
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    for name, (insns, labels) in functions(sass).items():
        if want not in name:
            continue
        print(f"{name}: {len(insns)} instructions")
        spans = []
        for lo, hi in sorted(set(loops(insns, labels))):
            body = [op for a, op, _ in insns if lo <= a <= hi]
            hits = sum(op.startswith(opcode) for op in body)
            spans.append((hi - lo, lo, hi, body, hits))
        inner = min((s for s in spans if s[4]), default=None)
        for span in spans:
            _, lo, hi, body, hits = span
            top = collections.Counter(op.split(".")[0] for op in body)
            mark = "  <- innermost with " + opcode if span is inner else ""
            print(f"  loop {lo:#06x}-{hi:#06x}: {len(body)} instructions, "
                  f"{hits} {opcode}; "
                  + ", ".join(f"{k} {v}" for k, v in top.most_common(8))
                  + mark)
    return 0


if __name__ == "__main__":
    sys.exit(main())

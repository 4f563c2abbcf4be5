#!/usr/bin/env python3
"""Registers, shared memory and the loops' instruction mix of CUDA kernels.

    python3 scripts/sass_report.py [source.cu ...]   # needs nvcc and cuobjdump

Compiles each source (default: the port's ``exact_nn.cu`` and
``point_align.cu``) to a cubin for ``sm_90a`` with the package's flags,
prints what ``ptxas -v`` says of every kernel (registers, spills, stack
frame, shared memory), disassembles it with ``cuobjdump -sass`` and prints,
for every loop of every kernel (a backward branch and the instructions from
its target up to it) that holds floating-point arithmetic, how many
instructions of each opcode one trip issues. Dividing by the pairs, points or
queries a trip serves gives the instructions per unit of work. Give another
version of a source (an older commit's copy) as a further argument to read
both side by side.
"""

import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "point_cloud_registration_tpu_torch" / "csrc"
sys.path.insert(0, str(ROOT))

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
SHOWN = ("LDS", "LDG", "FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "SEL", "SHFL",
         "ISETP", "IADD3", "IMAD", "LEA", "BRA")


def report(source: Path, nvcc: str) -> None:
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "kernel.cubin"
        out = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin",
             "-Xptxas", "-v", "-I", str(CSRC), "-o", str(cubin), str(source)],
            capture_output=True, text=True, check=True)
        print(f"== {source}")
        for line in (out.stdout + out.stderr).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.replace("ptxas info    : ", "").strip())
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True,
                              text=True, check=True).stdout
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        short = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}\d+", "", name)[:40]
        code = [(int(a, 16), op, mod, rest) for a, op, mod, rest in INSTR.findall(chunk)]
        loops = []  # (start, end) of every backward branch
        for addr, op, _, rest in code:
            target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if target is not None and int(target.group(1), 16) <= addr:
                loops.append((int(target.group(1), 16), addr))
        seen = collections.Counter()
        for start, end in loops:
            if any((a, b) != (start, end) and start <= a and b <= end for a, b in loops):
                continue  # holds another loop: only innermost loops are shown
            body = [(o, m) for a, o, m, _ in code if start <= a <= end]
            counts = collections.Counter(o for o, _ in body)
            if not counts["FADD"] + counts["FMUL"] + counts["FFMA"]:
                continue
            wide = sum(1 for o, m in body if o in ("LDS", "LDG") and ".128" in m)
            mix = ", ".join(f"{o} {counts[o]}" for o in SHOWN if counts[o])
            other = len(body) - sum(counts[o] for o in SHOWN)
            seen[f"{len(body)} instructions: {mix}, other {other} ({wide} of the loads 128-bit)"] += 1
        for line, times in seen.items():
            print(f"  {short}: innermost loop, {times} such: {line}")


def main() -> None:
    from point_cloud_registration_tpu_torch.ops.kernels._build import find_nvcc

    sources = [Path(a) for a in sys.argv[1:]] or [CSRC / "exact_nn.cu", CSRC / "point_align.cu"]
    nvcc = find_nvcc()
    for source in sources:
        report(source, nvcc)


if __name__ == "__main__":
    main()

"""Read a built kernel library's SASS: instructions per kernel instance,
the calls of the 64-bit integer division routine and the local-memory
accesses.

    python -m strongsort_yolo_tpu_torch.tools.sass LIBRARY KERNEL [KERNEL ...]

For each instance of each KERNEL (a substring of the mangled name) in
`cuobjdump -sass LIBRARY`, prints the calls of the software routine that
divides 64-bit integers (a division or remainder by a runtime value:
dozens of instructions a call) beside the calls of any routine, and the
local-memory loads and stores (``LDL``, ``STL``: registers spilled). The
routine is told by the conversion of its divisor, ``I2F.U64.RP`` (the inline
32-bit path converts with ``I2F.U32.RP``). Needs the CUDA toolkit's
cuobjdump (beside nvcc).
"""

from __future__ import annotations

import functools
import os
import re
import subprocess
import sys

# the 64-bit division routine converts its divisor with this instruction
DIV64_MARK = "I2F.U64.RP"
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_CALL = re.compile(r"CALL\.\S+\s+0x([0-9a-f]+)")
# a local-memory load or store, behind an optional predicate
_LOCAL = re.compile(r"^(@!?U?P[0-9T]+\s+)?(LDL|STL)\b")


@functools.lru_cache(maxsize=4)
def _sass(library: str) -> str:
    """`cuobjdump -sass` of ``library``, read once per process (a built
    library's name carries the hash of its sources)."""
    from strongsort_yolo_tpu_torch.ops.cuda import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def functions(library: str, kernel: str) -> dict[str, list[tuple[int, str]]]:
    """Per instance of ``kernel`` in ``library``, its (offset, instruction)
    lines, subroutines included."""
    funcs, fn = {}, None
    for line in _sass(library).splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if kernel in fn:
                funcs[fn] = []
        elif fn in funcs:
            m = _LINE.search(line)
            if m:
                funcs[fn].append((int(m.group(1), 16), m.group(2)))
    return funcs


def div64_calls(lines: list[tuple[int, str]]) -> tuple[int, int]:
    """(calls of the 64-bit division routine, calls of any routine) in one
    instance's lines: a call's routine runs from its target to its first
    RET."""
    at = {off: i for i, (off, _) in enumerate(lines)}
    div64 = calls = 0
    for _, ins in lines:
        m = _CALL.match(ins)
        if not m:
            continue
        calls += 1
        for _, sub in lines[at.get(int(m.group(1), 16), len(lines)):]:
            if DIV64_MARK in sub:
                div64 += 1
                break
            if sub.startswith("RET"):
                break
    return div64, calls


def local_accesses(library: str, kernel: str) -> dict[str, int]:
    """Per instance of ``kernel`` in ``library``, its local-memory loads
    and stores (``LDL``/``STL``): 0 where no register spills."""
    return {fn: sum(bool(_LOCAL.match(ins)) for _, ins in lines)
            for fn, lines in functions(library, kernel).items()}


def report(library: str, kernel: str) -> tuple[list[tuple[int, int]], int]:
    """-> ((64-bit division calls, calls) per instance, DIV64_MARK
    instructions anywhere in the instances)."""
    funcs = functions(library, kernel)
    if not funcs:
        raise ValueError(f"no {kernel} in {library}")
    marks = sum(DIV64_MARK in ins for lines in funcs.values()
                for _, ins in lines)
    return sorted(div64_calls(lines) for lines in funcs.values()), marks


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for kernel in argv[1:]:
        counts, marks = report(argv[0], kernel)
        print(f"{kernel}: {len(counts)} instances in "
              f"{os.path.basename(argv[0])}; 64-bit division calls per "
              f"instance {[c[0] for c in counts]}, calls of any routine "
              f"{[c[1] for c in counts]}, {DIV64_MARK} instructions {marks}, "
              f"local loads and stores per instance "
              f"{sorted(local_accesses(argv[0], kernel).values())}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Count the SASS instructions in the inner loops of the built kernels.

    python -m deepi2p_tpu_torch.sass_loops [name substring ...]

Builds the kernel library if needed (``nvcc``), disassembles it with the
CUDA toolkit's ``cuobjdump -sass`` and, for every kernel whose mangled
name holds one of the substrings (default: the 1-NN and LM kernels),
prints each innermost loop (the instructions from a backward branch's
target to the branch) with its length and its instruction mix.  Ratios
are printed beside: instructions per FMNMX (the 1-NN's one min per
(query, row)) and per two MUFU.RCP (an LM point's two divisions, 1 / p2
and val / (1 + |r|^2)).  Needs the CUDA toolkit, not a card.
"""
from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

from . import _build

DEFAULT = ("nn1_kernel", "lm_kernel")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(Path(_build.find_nvcc()).with_name("cuobjdump"))


def functions(sass: str):
    """{mangled name: [(address, instruction text)]}."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    """The opcode of an instruction, without predicate or modifiers."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def innermost_loops(insns):
    """[(start, end)] address ranges of the loops that hold no other."""
    loops = []
    for addr, text in insns:
        if opcode(text) == "BRA":
            m = _TARGET.search(text.split("BRA", 1)[1])
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
    return [(a, b) for a, b in loops
            if not any(a <= c and d <= b and (c, d) != (a, b)
                       for c, d in loops)]


def main(argv=None) -> None:
    keys = tuple(argv if argv else sys.argv[1:]) or DEFAULT
    lib = _build.build()
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    for name, insns in functions(sass).items():
        if not any(k in name for k in keys):
            continue
        print(f"{name}: {len(insns)} instructions", flush=True)
        for a, b in innermost_loops(insns):
            mix = collections.Counter(opcode(t) for x, t in insns
                                      if a <= x <= b)
            n = sum(mix.values())
            rcp = sum(1 for x, t in insns if a <= x <= b and "MUFU.RCP" in t)
            ratios = []
            if mix.get("FMNMX"):
                ratios.append(f"{n / mix['FMNMX']:.2f} per FMNMX")
            if rcp:
                ratios.append(f"{2 * n / rcp:.1f} per 2 MUFU.RCP")
            print(f"  loop 0x{a:x}-0x{b:x}: {n} instructions"
                  + (f" ({', '.join(ratios)})" if ratios else "") + "; "
                  + ", ".join(f"{o} {c}" for o, c in mix.most_common(12)),
                  flush=True)


if __name__ == "__main__":
    main()

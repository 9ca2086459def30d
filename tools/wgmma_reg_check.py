#!/usr/bin/env python3
"""Check in the compiled SASS that no register holding a `wgmma` A
operand is written while the product that reads it may still run.

ptxas guards the accumulators of an asynchronous `wgmma` but not its
register A operands: a register-A batch is only right if nothing writes
the fragment registers between the `HGMMA` that reads them and the
`WARPGROUP.DEPBAR` that waits for it.  For every kernel of the given
libraries this walks each window from a register-A `HGMMA` to the next
`WARPGROUP.DEPBAR` and reports any instruction in it whose destination
overlaps that `HGMMA`'s four A registers.

    python3 tools/wgmma_reg_check.py build/kernels/libflash-*.so ...

Needs `cuobjdump` (the CUDA toolkit).  Prints one line per kernel with
register-A products and exits 1 if any window is broken.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys

# opcodes whose first operand is not a destination register
NO_DEST = ("ST", "RED", "ATOM", "BAR", "BRA", "EXIT", "RET", "CALL", "WARP",
           "HGMMA", "DEPBAR", "MEMBAR", "FENCE", "ARRIVE", "SYNCS", "NOP",
           "BSYNC", "BSSY", "YIELD", "UTMA", "UBLKCP", "CCTL", "ERRBAR")


def written(op: str, args: str) -> set:
    """Registers an instruction writes (its first operand and, for wide
    results, the ones after it)."""
    if op.split(".")[0].startswith(NO_DEST) or op.startswith("@"):
        return set()
    m = re.match(r"\s*R(\d+)\b", args)
    if not m:
        return set()
    n = 1
    if ".128" in op:
        n = 4
    elif ".64" in op or ".WIDE" in op:
        n = 2
    r = int(m.group(1))
    return set(range(r, r + n))


def check(sass: str):
    """(kernel, register-A products, broken windows) for each kernel."""
    out = []
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        lines = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", func)
        open_a = []         # A register sets of the products in flight
        n_ra, bad = 0, []
        for ins in lines:
            ins = re.sub(r"^@!?U?P\w+\s+", "", ins.strip())
            op, _, args = ins.partition(" ")
            if op.startswith("HGMMA"):
                m = re.match(r"\s*R\d+\s*,\s*R(\d+)\b", args)
                if m:
                    a = int(m.group(1))
                    open_a.append(set(range(a, a + 4)))
                    n_ra += 1
                continue
            if op.startswith("WARPGROUP.DEPBAR"):
                open_a = []
                continue
            w = written(op, args)
            for regs in open_a:
                if w & regs:
                    bad.append(ins)
        if n_ra:
            out.append((name, n_ra, bad))
    return out


def main(paths) -> int:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    broken = 0
    for path in paths:
        sass = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, check=True).stdout
        for name, n_ra, bad in check(sass):
            broken += len(bad)
            print(f"{path.rsplit('/', 1)[-1]}: {name[:70]}: {n_ra} "
                  f"register-A products, "
                  f"{len(bad)} writes to their registers before the wait"
                  + "".join(f"\n    {b}" for b in bad[:5]))
    return 1 if broken else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

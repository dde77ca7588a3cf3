"""Count the SASS instructions of the probe kernels of a checkout on the card.

    python tools/sass_counts.py [--tree DIR] [--all] [--raw FILE]

Builds ``DIR``'s probes library (``pomcpp_tpu_torch._ext``, default: this
checkout), disassembles it with ``cuobjdump -sass`` and prints one JSON
object a probe kernel (every function whose mangled name holds
``probe_``): ``{"kernel", "instructions", "opcodes"}``, the static count
of each base opcode (``SHFL.BFLY`` counts as ``SHFL``).  ``--all`` prints
every opcode, else only those that tell a design apart (shuffles, votes,
warp reductions, conversions, shared-memory accesses, barriers); ``--raw
FILE`` writes the probe kernels' SASS there.
Static counts: a loop's body once, however often it runs.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SHOWN = ("SHFL", "VOTE", "REDUX", "I2F", "I2FP", "F2I", "LDS", "STS", "BAR",
         "FFMA", "FADD", "LOP3", "IADD3", "SEL", "IMNMX", "VIMNMX", "PRMT",
         "SHF", "ISETP", "PLOP3", "IMAD", "LEA", "MOV")
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return "/usr/local/cuda/bin/cuobjdump"


def functions(sass: str):
    """(mangled name, Counter of base opcodes, SASS lines) for each
    function."""
    name, counts, lines = None, Counter(), []
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            if name:
                yield name, counts, lines
            name, counts, lines = head.group(1), Counter(), []
            continue
        m = INSTR.search(line)
        if name and m:
            counts[m.group(1).split(".")[0]] += 1
            lines.append(line.split(";")[0].strip() + " ;")
    if name:
        yield name, counts, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--raw", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    ext = importlib.import_module("pomcpp_tpu_torch._ext")
    lib = ext.build(("probes",))["probes"]
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    print(f"library: {lib}")
    raw = []
    for name, counts, lines in functions(sass):
        if "probe_" not in name:
            continue
        raw += [f"Function : {name}", *lines, ""]
        shown = counts if args.all else {k: counts[k] for k in SHOWN if counts[k]}
        print(json.dumps({"kernel": name, "instructions": sum(counts.values()),
                          "opcodes": dict(sorted(shown.items()))}))
    if args.raw:
        Path(args.raw).write_text("\n".join(raw))
    return 0


if __name__ == "__main__":
    sys.exit(main())

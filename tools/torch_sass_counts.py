"""Count the SASS instructions of the port's flash kernels by opcode.

Builds ``csrc/<source>.cu`` as the port builds it (``kernels/build.py``),
disassembles the library with ``cuobjdump -sass`` and prints, for each
kernel whose demangled name contains ``--match``, its instruction count and
how many of them are tensor-core products (``HGMMA``), FP32 FMAs, shared
loads and stores, special-function calls and barriers: enough to see that
a kernel's products run on the tensor cores and no FMA product loop is
left. Runs only where the CUDA toolkit is installed (on the card's
machine):

    python3 tools/torch_sass_counts.py [--source flash_attention_fwd]
        [--match tf32]
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OPS = ("HGMMA", "FFMA", "FMUL", "FADD", "LDS", "STS", "LDL", "STL", "MUFU",
       "BAR")


def demangle(names):
    cxxfilt = shutil.which("c++filt")
    if not cxxfilt or not names:
        return names
    out = subprocess.run([cxxfilt], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            for n in out.splitlines()]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default="flash_attention_fwd")
    ap.add_argument("--match", default="tf32")
    args = ap.parse_args()
    from flexflow_tpu_torch.kernels import build
    build.build_all([args.source])
    lib = build._lib_path(args.source)
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, counts = [], []
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            funcs.append(m.group(1))
            counts.append(collections.Counter())
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     ln)
        if m and counts:
            counts[-1]["all"] += 1
            counts[-1][m.group(1).split(".")[0]] += 1
    for name, c in sorted(zip(demangle(funcs), counts)):
        if args.match in name:
            print(f"[sass] {name}: {c['all']} instructions, "
                  + ", ".join(f"{op} {c[op]}" for op in OPS))
    return 0


if __name__ == "__main__":
    sys.exit(main())

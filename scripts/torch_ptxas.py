"""Registers, stack and spills of every kernel of the port, as ptxas reports
them.

    python scripts/torch_ptxas.py [--csrc DIR] [NAME ...]

Compiles each named ``ops/csrc/NAME.cu`` (all of them by default; from DIR
in place of ``ops/csrc``, e.g. another tree's) with the build's own nvcc
flags plus ``-Xptxas -v`` into a temporary directory, and prints one JSON
line for each kernel instantiation: its name (demangled with ``cu++filt``
where the toolkit has it), registers, barriers, shared memory, stack frame
and spill bytes. Needs ``nvcc``, not a card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from semantic_abstraction_tpu_torch.ops import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\w+)'")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers(?:, used (\d+) barriers)?(?:, (\d+) bytes smem)?")


def demangle(names):
    tool = shutil.which("cu++filt") or os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    if not os.path.exists(tool):
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def report(csrc: str, name: str, tmp: str):
    src = os.path.join(csrc, name + ".cu")
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          os.path.join(tmp, name + ".so"), src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out.stderr}")
    rows = []
    for line in (out.stdout + out.stderr).splitlines():
        if m := ENTRY.search(line):
            rows.append({"source": name, "kernel": m.group(1)})
        elif rows and (m := FRAME.search(line)):
            rows[-1].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        elif rows and (m := USED.search(line)):
            rows[-1].update(registers=int(m.group(1)), barriers=int(m.group(2) or 0),
                            smem_bytes=int(m.group(3) or 0))
    for row, full in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = full
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=_build.CSRC_DIR)
    ap.add_argument("names", nargs="*")
    args = ap.parse_args()
    names = args.names or [n for n in _build.KERNELS
                           if os.path.exists(os.path.join(args.csrc, n + ".cu"))]
    tmp = tempfile.mkdtemp(prefix="ptxas_")
    try:
        for name in names:
            for row in report(args.csrc, name, tmp):
                print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

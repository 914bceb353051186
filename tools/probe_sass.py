"""The instructions of the probe kernels' inner loops, read from the built
library's SASS: what a step of csrc/alu_probe.cu and csrc/tanh_probe.cu
costs in instructions (PERF.md counts tanhf's step from it).

    python3 tools/probe_sass.py

Run from the repository root on the machine with the CUDA toolkit.  Builds
csrc/*.cu if needed (utils/build.py), runs ``cuobjdump -sass`` on the
library and, for each instance of ``alu_probe_kernel`` and
``tanh_probe_kernel``, prints its longest loop (from a backward branch's
target to the branch) by opcode, and the steps one pass of that loop takes
(the constant its counter falls by: the compiler's unrolling).  Divide the
counts by the steps for one step.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: an instruction line: address, optional predicate, opcode, operands
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T\d]\s+)?"
                    r"([A-Z][A-Z0-9_.]*)([^;]*);")
#: a loop counter falling by a constant: -0xN, or 2^32 - N written out
_COUNTER = re.compile(r"(?:IADD3|VIADD)\s+(R\d+),\s*\1,\s*"
                      r"(-0x[0-9a-f]+|0xf[0-9a-f]{7})\b")


def functions(sass: str):
    """{mangled name: [(address, opcode, operands), ...]} of a SASS dump."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = [(int(a, 16), op, args.strip())
                             for a, _, op, args in _INSTR.findall(body)]
    return out


def longest_loop(instrs):
    """(opcode counts, steps a pass) of the longest backward-branch loop."""
    best = []
    for addr, op, args in instrs:
        if op.startswith("BRA") and args.startswith("0x"):
            target = int(args.split()[0], 16)
            if target < addr:
                body = [x for x in instrs if target <= x[0] <= addr]
                best = max(best, body, key=len)
    steps = 1
    for _, op, args in best:
        m = _COUNTER.search(f"{op} {args}")
        if m:
            value = int(m.group(2), 16)
            steps = -value if value < 0 else 2 ** 32 - value
    counts = collections.Counter(op.split(".")[0] for _, op, _ in best
                                 if op != "NOP")
    return counts, steps


def main() -> None:
    from code_robchar_tpu_torch.utils import build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build.build().path],
                          capture_output=True, text=True, check=True).stdout
    for name, instrs in sorted(functions(sass).items()):
        if "alu_probe_kernel" not in name and "tanh_probe_kernel" not in name:
            continue
        counts, steps = longest_loop(instrs)
        kernel = re.search(r"(alu|tanh)_probe_kernelILi(\d)E", name)
        print(f"{kernel.group(1)}_probe_kernel<{kernel.group(2)}>: "
              f"{sum(counts.values())} instructions a pass of {steps} "
              f"steps: {dict(counts.most_common())}")


if __name__ == "__main__":
    main()

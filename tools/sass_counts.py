"""Count the tensor-core and FMA instructions of each kernel in the built
CUDA libraries of the port, from ``cuobjdump -sass``.

    python tools/sass_counts.py [NAME ...]

NAME is a source under ``packppi_torch/csrc`` (default: the sources with
tensor-core kernels, message, message_feat, layer and chain), built first
if needed. For every kernel function of the
library it prints the number of SASS lines with HGMMA (wgmma), HMMA
(mma.sync) and FFMA (float32 FMA), with the demangled name.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OPS = ("HGMMA", "HMMA", "FFMA")


def counts(lib: Path) -> dict[str, Counter]:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out: dict[str, Counter] = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = Counter()
            continue
        if fn is None:
            continue
        for op in OPS:
            if re.search(rf"\b{op}\b", line):
                out[fn][op] += 1
    return out


def main():
    from packppi_torch.ops import _build

    names = sys.argv[1:] or ["message", "message_feat", "layer", "chain"]
    paths = _build.build_all(names)
    cxxfilt = shutil.which("c++filt")
    for name in names:
        for fn, c in counts(paths[name]).items():
            pretty = (subprocess.run([cxxfilt, fn], capture_output=True, text=True).stdout.strip()
                      if cxxfilt else fn)
            print(f"{name}: {pretty}: " + ", ".join(f"{op} {c[op]}" for op in OPS), flush=True)


if __name__ == "__main__":
    main()

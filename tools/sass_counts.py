"""Count the tensor-core and FMA instructions of each kernel in the built
CUDA libraries of the port, from ``cuobjdump -sass``.

    python tools/sass_counts.py [NAME ...]

NAME is a build of ``packppi_torch/ops/_build.py``: a source under
``packppi_torch/csrc`` (default: the sources with tensor-core kernels,
message, message_feat, layer and chain) or ``<source>@<activation>``,
built first if needed. For every kernel function of the library it prints
the number of SASS lines with HGMMA (wgmma), HMMA (mma.sync) and FFMA
(float32 FMA), the number of SASS instructions, and a sha256 of the
function's instructions with their addresses left out (two builds with the
same hash run the same code), with the demangled name.
"""
from __future__ import annotations

import hashlib
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OPS = ("HGMMA", "HMMA", "FFMA")


# one SASS instruction line: /*0a50*/  <instruction> ;  /* encoding */
INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?;)")


def counts(lib: Path) -> dict[str, Counter]:
    """Per kernel function: the counts of ``OPS``, ``SASS`` (instructions)
    and ``sha`` (sha256 of the instruction text, addresses left out)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out: dict[str, Counter] = {}
    hashes: dict[str, "hashlib._Hash"] = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = Counter()
            hashes[fn] = hashlib.sha256()
            continue
        if fn is None:
            continue
        ins = INSTRUCTION.match(line)
        if ins:
            out[fn]["SASS"] += 1
            hashes[fn].update(ins.group(1).encode() + b"\n")
        for op in OPS:
            if re.search(rf"\b{op}\b", line):
                out[fn][op] += 1
    for fn, h in hashes.items():
        out[fn]["sha"] = h.hexdigest()[:16]
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
            print(f"{name}: {pretty}: " + ", ".join(f"{op} {c[op]}" for op in OPS)
                  + f", SASS {c['SASS']}, sha {c['sha']}", flush=True)


if __name__ == "__main__":
    main()

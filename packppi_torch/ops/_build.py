"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into
``packppi_torch/_build/<name>-<hash>.so``. The hash covers the source, the
shared headers and the flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. Builds run at first use; ``build_all``
starts one ``nvcc`` per source, all at once.

The message and chain sources (``ACT_SOURCES``) apply the MLPs' activation
chosen at build time: a build name ``"<source>@<act>"`` compiles the source
with ``-DPACKPPI_ACT=<index in ACTS>`` into its own library
(``<source>@<act>-<hash>.so``); the bare source name is relu, built with
no such flag. A library per activation keeps every body free of a switch.

They take the network's widths at build time too: H (``hidden_dim``), He
(``edge_features``) and P (``n_points``), any of ``KERNEL_H`` and
``KERNEL_P`` (``width_refusals``); the neighbour count K is a launch
argument. Away from the default widths (128, 128, 8) the build name carries
them, ``"<source>@<act>@H<H>-He<He>-P<P>"`` (``chain@<act>@H<H>``: the chain
takes H only), compiled with ``-DPACKPPI_H=``, ``-DPACKPPI_HE=`` and
``-DPACKPPI_P=``; at the default widths the name and the flags are as above.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the activation table of the message and chain bodies (csrc/tile.cuh act),
# in the order of its PACKPPI_ACT_* numbers; models.layers.ACTS holds the
# plain versions
ACTS = ("relu", "gelu", "elu", "selu", "celu", "leaky_relu", "silu", "sigmoid")
ACT_SOURCES = ("message", "message_feat", "layer", "chain")

# the widths the message, chain and layer kernels are built for (csrc/tile.cuh):
# H and He every multiple of 32 from 32 to 256 (each row of a LayerNorm is
# H / 32 values a lane; wgmma's N, which is H, ends at 256), P from 1 to 16
KERNEL_H = tuple(range(32, 257, 32))
KERNEL_P = tuple(range(1, 17))
DEFAULT_WIDTHS = (128, 128, 8)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin); the CUDA "
                       "kernels of packppi_torch are built from csrc/ at first use")


def width_refusals(H: int, He: int = 128, P: int = 8) -> list:
    """``name=value`` of each width the kernels are not built for (empty
    when they take H = ``hidden_dim``, He = ``edge_features`` and P =
    ``n_points``)."""
    bad = [f"hidden_dim={H}"] if H not in KERNEL_H else []
    bad += [f"edge_features={He}"] if He not in KERNEL_H else []
    return bad + ([f"n_points={P}"] if P not in KERNEL_P else [])


def check_widths(what: str, H: int, He: int = 128, P: int = 8) -> None:
    """Raise, naming the width, unless the kernels take (H, He, P)."""
    bad = width_refusals(H, He, P)
    if bad:
        raise ValueError(f"{what}: no kernel is built for {', '.join(bad)} (hidden_dim and "
                         f"edge_features: a multiple of 32 from 32 to 256; n_points: 1 to 16)")


def _width_tag(source: str, H: int, He: int, P: int) -> str:
    if source == "chain":
        return "" if H == DEFAULT_WIDTHS[0] else f"H{H}"
    return "" if (H, He, P) == DEFAULT_WIDTHS else f"H{H}-He{He}-P{P}"


def lib_name(source: str, act: str = "relu", H: int = 128, He: int = 128, P: int = 8) -> str:
    """The build name of ``csrc/<source>.cu`` with activation ``act`` at
    widths (H, He, P) (the chain reads H only)."""
    if act not in ACTS:
        raise ValueError(f"activation {act!r} is not one of {ACTS}")
    tag = _width_tag(source, H, He, P)
    if act == "relu" and not tag:
        return source
    if source not in ACT_SOURCES:
        raise ValueError(f"csrc/{source}.cu takes no activation and no width "
                         f"(only {ACT_SOURCES})")
    if tag:
        check_widths(f"csrc/{source}.cu", H, He, P)
        return f"{source}@{act}@{tag}"
    return f"{source}@{act}"


def _flags(name: str):
    """(source, nvcc flags) of a build name."""
    source, _, rest = name.partition("@")
    if not rest:
        return source, NVCC_FLAGS
    act, _, tag = rest.partition("@")
    widths = dict(zip(("H", "He", "P"), DEFAULT_WIDTHS))
    for part in filter(None, tag.split("-")):
        key = part.rstrip("0123456789")
        if key not in widths or not part[len(key):]:
            raise ValueError(f"build name {name!r}: width {part!r} is not H<n>, He<n> or P<n>")
        widths[key] = int(part[len(key):])
    lib_name(source, act, **widths)   # refuses an unknown source, activation or width
    if tag != _width_tag(source, **widths):
        raise ValueError(f"build name {name!r}: the widths are not written as lib_name writes them")
    flags = (*NVCC_FLAGS, f"-DPACKPPI_ACT={ACTS.index(act)}")
    if tag:
        flags += (f"-DPACKPPI_H={widths['H']}", f"-DPACKPPI_HE={widths['He']}",
                  f"-DPACKPPI_P={widths['P']}")
    return source, flags


def _target(name: str) -> Path:
    source, flags = _flags(name)
    h = hashlib.sha256()
    for p in [CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for build ``name`` unless its library exists; returns
    (target, process or None, tmp path)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    source, flags = _flags(name)
    cmd = [_nvcc(), *flags, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, proc, tmp


def _finish(name: str, target: Path, proc, tmp: Path) -> str:
    """Wait for one build; returns "" or its error message."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    target.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed for {name} (exit {proc.returncode}):\n{log}"
    os.replace(tmp, target)
    return ""


def build_all(names) -> dict[str, Path]:
    """Build every named source in parallel (one nvcc each) and wait for
    all of them; returns the library paths, or raises if any build failed."""
    started = {n: _start(n) for n in names}
    errors = [_finish(n, *s) for n, s in started.items()]
    if any(errors):
        raise RuntimeError("\n".join(e for e in errors if e))
    return {n: s[0] for n, s in started.items()}


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    the current build of ``name``, or "" if it was built by another run."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of build ``name`` (``lib_name``), built on first
    use. A build that fails raises: no activation falls back to another."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            lib.packppi_error_string.argtypes = [ctypes.c_int]
            lib.packppi_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def launch_kernel(lib: ctypes.CDLL, entry: str, what: str, device, *args) -> None:
    """Call the C entry point ``entry`` of ``lib`` with ``args`` and the
    current stream of ``device``, and raise on its error code. The entry
    points launch on the calling thread's current CUDA device, so ``device``
    (the operands') is made current for the call: a wrapper called on
    ``cuda:1`` while ``cuda:0`` is current launches on ``cuda:1``."""
    import torch

    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, stream_ptr(device))
    check(lib, err, what)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.packppi_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def check_operands(name, ref, expect):
    """Device, dtype, shape and contiguity of every kernel operand."""
    if not ref.is_contiguous():
        raise ValueError(f"{name} kernel: its main operand must be contiguous")
    for arg, (t, shape, dtype) in expect.items():
        if t.device != ref.device:
            raise ValueError(f"{name} kernel: {arg} on {t.device}, expected {ref.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} kernel: {arg} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} kernel: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {arg} must be contiguous")


def check_aligned(name, **tensors):
    """The kernels copy these operands 16 bytes at a time: each must start
    on a 16-byte boundary (a fresh allocation does; a view may not)."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {arg} must start on a 16-byte boundary")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

"""Native host library: the C++ PDB parser and Shrake-Rupley SASA, via ctypes.

``src/pdbio.cpp`` (the port's own copy of the JAX package's source) is
built with g++ at first use into ``packppi_torch/_build/pdbio-<hash>.so``,
the hash covering the source and the flags, as ``ops/_build.py`` builds the
kernels; no binary ships in the repository. The flags are the JAX
package's (``-O3 -march=native``), so on one machine both packages parse
the same coordinates, stored as float32, and compute the same per-atom
SASA bit for bit.

The library is host code: where it cannot be built or loaded (no g++), or
with ``PACKPPI_NATIVE=0``, ``parse_pdb_native`` and ``sasa_native`` return
None and their callers take the pure-Python paths, as the JAX package's do.
``library_path()`` says whether the library was built and loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "pdbio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_path: Optional[Path] = None
_load_failed = False
_error = ""
_LOCK = threading.Lock()


def native_enabled() -> bool:
    return os.environ.get("PACKPPI_NATIVE", "1") != "0"


def _target() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"pdbio-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> str:
    """Compile the library into ``target``; returns "" or why it failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name per process: concurrent builders never write one file, and the
    # rename publishes a whole library
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, target)
        return ""
    except subprocess.CalledProcessError as e:
        err = f"g++ failed (exit {e.returncode}):\n{e.stderr}"
    except (OSError, subprocess.SubprocessError) as e:
        err = f"g++ could not run: {e}"
    tmp.unlink(missing_ok=True)
    return err


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None if it is disabled or
    cannot be built or loaded."""
    global _lib, _path, _load_failed, _error
    with _LOCK:
        if _lib is not None or _load_failed or not native_enabled():
            return _lib
        target = _target()
        if not target.exists():
            _error = _build(target)
        if not _error:
            try:
                lib = ctypes.CDLL(str(target))
            except OSError as e:
                _error = f"cannot load {target}: {e}"
        if _error:
            _load_failed = True
            return None
        lib.ppi_parse_pdb.restype = ctypes.c_int
        lib.ppi_sasa.restype = None
        _lib, _path = lib, target
        return _lib


def library_path() -> Optional[Path]:
    """The path of the loaded library, or None if none is loaded."""
    return _path if _lib is not None else None


def build_error() -> str:
    """Why the library could not be built or loaded ("" if it was, or was
    not tried)."""
    return _error


def _chem_blobs():
    from packppi_torch.chem import ATOM14_NAMES, RESTYPE_1TO3, RESTYPES

    resnames = "".join(RESTYPE_1TO3[r] for r in RESTYPES).encode()
    atoms = "".join(f"{a:<4}" for r in RESTYPES for a in ATOM14_NAMES[RESTYPE_1TO3[r]]).encode()
    return resnames, atoms


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_pdb_native(pdb_str: str, model_idx: int = 0, chain_id=None,
                     discard_water: bool = True, mse_to_met: bool = False,
                     ignore_non_std: bool = True) -> Optional[dict]:
    """The native twin of ``structure.protein.from_pdb_string``: the
    ``Protein`` field arrays (positions parsed into float32, then widened),
    or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if chain_id is None:
        chain_filter = b""
    elif isinstance(chain_id, str):
        chain_filter = chain_id.encode()
    else:
        chain_filter = ",".join(chain_id).encode()

    text = pdb_str.encode()
    max_res = max(pdb_str.count("\n") + 1, 8)
    positions = np.empty((max_res, 14, 3), np.float32)
    atom_mask = np.empty((max_res, 14), np.float32)
    bfac = np.empty((max_res, 14), np.float32)
    aaindex = np.empty(max_res, np.int32)
    residx = np.empty(max_res, np.int32)
    chains = np.empty(max_res, np.uint8)
    resnames, atoms = _chem_blobs()
    n = lib.ppi_parse_pdb(
        text, ctypes.c_long(len(text)), model_idx, int(discard_water), int(mse_to_met),
        int(ignore_non_std), chain_filter, resnames, atoms, max_res,
        _ptr(positions, ctypes.c_float), _ptr(atom_mask, ctypes.c_float),
        _ptr(bfac, ctypes.c_float), _ptr(aaindex, ctypes.c_int), _ptr(residx, ctypes.c_int),
        _ptr(chains, ctypes.c_char))
    if n < 0:
        return None
    return {
        "atom_positions": positions[:n].astype(np.float64),
        "atom_mask": atom_mask[:n].astype(np.float64),
        "b_factors": bfac[:n].astype(np.float64),
        "aaindex": aaindex[:n].astype(np.int64),
        "residue_index": residx[:n].astype(np.int64),
        "chain_id": np.array([chr(c) for c in chains[:n]]),
    }


def sasa_native(positions: np.ndarray, radii: np.ndarray, n_points: int = 100,
                probe: float = 1.4) -> Optional[np.ndarray]:
    """Per-atom Shrake-Rupley SASA (float32 arithmetic, widened to float64);
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, np.float32)
    rad = np.ascontiguousarray(radii, np.float32)
    out = np.empty(len(rad), np.float32)
    lib.ppi_sasa(_ptr(pos, ctypes.c_float), _ptr(rad, ctypes.c_float), len(rad), n_points,
                 ctypes.c_float(probe), _ptr(out, ctypes.c_float))
    return out.astype(np.float64)

"""Complex pre-training dataset: PDB directory scan, split, feature cache.

Host-side pipeline: scans a directory of
complex PDBs, filters by residue count, splits train/val/test with a seeded
shuffle persisted to disk, and caches each protein's canonical feature dict
as compressed npz (parse+featurize runs once per structure ever).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from packppi_torch.structure.featurize import featurize
from packppi_torch.structure.protein import from_pdb_file
from packppi_torch.utils.logging import get_logger

log = get_logger(__name__)


def scan_complex_dir(path: str, suffix: str = "_rc") -> list[str]:
    """PDB codes in ``path`` whose files look like ``<code><suffix>.pdb``.
    (Length filtering happens in ``ComplexDataset.filtered()``, which can
    read cached lengths — a filter here would force a parse per file.)"""
    out = []
    for f in sorted(Path(path).glob(f"*{suffix}.pdb")):
        out.append(f.name[: -len(suffix) - 4] if suffix else f.stem)
    return out


def split_entries(entries: list[str], fractions: Sequence[float] = (0.8, 0.1, 0.1),
                  seed: int = 42, split_file: Optional[str] = None) -> dict[str, list[str]]:
    """Seeded random train/val/test split, persisted as JSON for stability
    across runs. A reused
    split is reconciled against the current directory: codes that vanished
    are pruned (they would only surface later as per-entry parse errors)
    and NEW codes are reported — they stay out of every split so a stale
    shared split file cannot silently change what 'test' meant."""
    if split_file and Path(split_file).exists():
        splits = json.loads(Path(split_file).read_text())
        present = set(entries)
        persisted = {c for v in splits.values() for c in v}
        missing = persisted - present
        if missing:
            log.warning(f"split file {split_file}: pruning "
                        f"{len(missing)} persisted code(s) no longer on disk")
            splits = {k: [c for c in v if c in present] for k, v in splits.items()}
            # persist the reconciliation: otherwise every later run re-walks
            # and re-warns about the same vanished codes forever (new codes
            # stay unused either way — only deletion is written back)
            Path(split_file).write_text(json.dumps(splits))
        new = present - persisted
        if new:
            log.warning(f"split file {split_file}: {len(new)} new code(s) on "
                        "disk are NOT in the persisted split and will be "
                        "unused; delete the split file to re-split")
        return splits
    rng = np.random.default_rng(seed)
    order = list(entries)
    rng.shuffle(order)
    n = len(order)
    n_train = int(fractions[0] * n)
    n_val = int(fractions[1] * n)
    splits = {
        "train": order[:n_train],
        "val": order[n_train:n_train + n_val],
        "test": order[n_train + n_val:],
    }
    if split_file:
        Path(split_file).parent.mkdir(parents=True, exist_ok=True)
        Path(split_file).write_text(json.dumps(splits))
    return splits


class ComplexDataset:
    """Lazily featurized, npz-cached protein complexes."""

    def __init__(self, pdb_dir: str, entries: list[str], cache_dir: Optional[str] = None,
                 suffix: str = "_rc", len_region: Sequence[int] = (10, 3000)):
        self.pdb_dir = Path(pdb_dir)
        self.entries = list(entries)
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.suffix = suffix
        self.len_region = tuple(len_region)
        self._length_cache: Optional[dict] = None
        self._manifest_dirty = False
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def __len__(self) -> int:
        return len(self.entries)

    def pdb_path(self, code: str) -> Path:
        return self.pdb_dir / f"{code}{self.suffix}.pdb"

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        code = self.entries[idx]
        cache = self.cache_dir / f"{code}.npz" if self.cache_dir else None
        if cache and cache.exists():
            with np.load(cache) as z:
                return dict(z)
        feats = featurize(from_pdb_file(self.pdb_path(code), mse_to_met=True))
        L = len(feats["residue_type"])
        if not (self.len_region[0] <= L <= self.len_region[1]):
            raise ValueError(f"{code}: {L} residues outside {self.len_region}")
        if cache:
            np.savez_compressed(cache, **feats)
        return feats

    def _manifest_path(self) -> Optional[Path]:
        return self.cache_dir / "lengths.json" if self.cache_dir else None

    def length(self, idx: int) -> int:
        """Residue count WITHOUT featurizing: manifest hit, else a parse-only
        scan (no dihedrals/frames), recorded in the manifest for next time.
        Keeps the loader's bucket planning O(manifest read) instead of a
        serial full-corpus featurization stall."""
        if self._length_cache is None:
            mp = self._manifest_path()
            self._length_cache = (json.loads(mp.read_text())
                                  if mp and mp.exists() else {})
        code = self.entries[idx]
        if code not in self._length_cache:
            prot = from_pdb_file(self.pdb_path(code), mse_to_met=True)
            self._length_cache[code] = int(len(prot.aaindex))
            self._manifest_dirty = True
        return self._length_cache[code]

    def _save_manifest(self):
        mp = self._manifest_path()
        if mp and getattr(self, "_manifest_dirty", False):
            tmp = mp.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(self._length_cache))
            tmp.replace(mp)
            self._manifest_dirty = False

    def lengths(self) -> list[int]:
        """Residue counts for bucket planning (manifest-backed, parse-only)."""
        out = [self.length(i) for i in range(len(self))]
        self._save_manifest()
        return out

    def filtered(self) -> "ComplexDataset":
        """Drop entries outside len_region, resolving lengths from
        the manifest / npz feature cache when available, so a warm-cache
        training startup never re-featurizes the corpus (the module
        contract: parse+featurize once per structure EVER); only fresh
        structures are featurized here, and their features are cached."""
        if self._length_cache is None:
            mp = self._manifest_path()
            self._length_cache = (json.loads(mp.read_text())
                                  if mp and mp.exists() else {})
        keep = []
        for code in self.entries:
            L = self._length_cache.get(code)
            npz = (self.cache_dir / f"{code}.npz") if self.cache_dir else None
            if L is None and npz is not None and npz.exists():
                with np.load(npz) as z:
                    L = int(z["residue_type"].shape[0])
                self._length_cache[code] = L
                self._manifest_dirty = True
            if L is None:
                try:
                    feats = featurize(from_pdb_file(self.pdb_path(code),
                                                    mse_to_met=True))
                except Exception as e:
                    log.warning(f"skipping {code}: parse failed ({e})")
                    continue
                L = len(feats["residue_type"])
                self._length_cache[code] = L
                self._manifest_dirty = True
                if npz is not None and self.len_region[0] <= L <= self.len_region[1]:
                    np.savez_compressed(npz, **feats)
            if self.len_region[0] <= L <= self.len_region[1]:
                keep.append(code)
            else:
                log.warning(f"skipping {code}: {L} residues outside {self.len_region}")
        self._save_manifest()
        return ComplexDataset(str(self.pdb_dir), keep,
                              cache_dir=str(self.cache_dir) if self.cache_dir else None,
                              suffix=self.suffix, len_region=self.len_region)

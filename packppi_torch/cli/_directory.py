"""Directory mode of the pack and prox CLIs, and the output merge they share.

``cli.pack --input dir/`` and ``cli.prox --input dir/`` run one skeleton:
parse and featurize every PDB on a thread pool, group the structures by
length bucket, and take fixed-size chunks of a bucket one device pass at a
time, the tail chunk padded with repeats of its last member. Host work
(structure merge, PDB writes, metric suites) runs on a writer pool while
the device takes the next chunk; a failed writer becomes a record of its
error, not an abort.

On ``--n_devices`` ranks (``on_ranks``) a chunk holds ``batch_size`` rows a
rank: every rank walks the same chunks, runs its rows (``sharding_env``) and
the results are gathered to rank 0, whose writer pool writes them.
"""
from __future__ import annotations

import dataclasses
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def merge_output_structure(prot, feats, atom_mask, coords, L):
    """Rebuilt coordinates for modelled residues; residues the model cannot
    represent (incomplete backbone -> residue_mask 0) pass through unchanged
    so the output keeps the input's residue count. ``coords`` [1, L_pad, 14,
    3] and ``atom_mask`` [1, L_pad, 14] are numpy."""
    rm = feats["residue_mask"].astype(bool)
    pos = np.where(rm[:, None, None], coords[0, :L], np.nan_to_num(prot.atom_positions))
    mask = np.where(rm[:, None], atom_mask[0, :L], prot.atom_mask)
    return dataclasses.replace(prot, atom_positions=pos, atom_mask=mask)


def load_directory(input_path, require_chis: bool = False):
    """Parse and featurize every ``*.pdb`` under ``input_path``.

    Returns ``(proteins, feats, skipped)``: ``proteins`` a list of ``(path,
    Protein)`` aligned with ``feats``; with ``require_chis``, structures
    without a single side-chain chi go to ``skipped`` (the proximal
    objective is undefined for them).
    """
    from packppi_torch.structure import featurize, from_pdb_file

    pdbs = sorted(Path(input_path).glob("*.pdb"))
    if not pdbs:
        raise SystemExit(f"no PDBs in {input_path}")

    # parsing holds the GIL; the pool is for featurize's numpy
    with ThreadPoolExecutor(max_workers=8) as tp:
        parsed = list(tp.map(lambda p: from_pdb_file(p, mse_to_met=True), pdbs))
        all_feats = list(tp.map(featurize, parsed))

    if not require_chis:
        return list(zip(pdbs, parsed)), all_feats, []

    proteins, feats, skipped = [], [], []
    for p, prot, f in zip(pdbs, parsed, all_feats):
        if f["SC_D_mask"].sum() == 0:
            skipped.append(str(p))
            continue
        proteins.append((p, prot))
        feats.append(f)
    if skipped:
        print(f"skipping {len(skipped)} structure(s) without side-chain chis")
    if not feats:
        raise SystemExit("no structure in the directory has side chains")
    return proteins, feats, skipped


def resolve_n_devices(args) -> int:
    """Ranks of a run: ``--n_devices`` (None: every visible card, one on the
    CPU), a request above the visible cards clamped with a warning, as the
    JAX package clamps to its devices; ``--device cpu --n_devices N`` runs N
    ranks on the host."""
    import torch

    from packppi_torch.parallel.launch import resolve_ranks

    device = getattr(args, "device", None) or ("cuda" if torch.cuda.is_available() else "cpu")
    return resolve_ranks(getattr(args, "n_devices", None), torch.device(device),
                         share_device=bool(getattr(args, "share_device", False)))


def on_ranks(fn, args, device, n_devices: int):
    """``fn(args, device, mesh)`` on one device (mesh None), or on
    ``n_devices`` ranks over a data mesh (``args.share_device``: every rank
    on one card over gloo); returns rank 0's result."""
    if n_devices == 1:
        return fn(args, device, None)
    from packppi_torch.parallel.launch import launch

    return launch(_rank_entry, n_devices, device, fn, args,
                  share_device=bool(getattr(args, "share_device", False)))[0]


def _rank_entry(fn, args):
    from packppi_torch.parallel.launch import current
    from packppi_torch.parallel.mesh import make_mesh

    return fn(args, current().device, make_mesh(1))


def sharding_env(mesh):
    """``(rows, gather)`` of a pass over a data mesh: ``rows(n)`` is this
    rank's slice of ``n`` rows (``n`` divisible by the ranks), ``gather(x)``
    the rows of every rank, on every rank. On one device (``mesh`` None) the
    whole range and the identity."""
    if mesh is None:
        return (lambda n: slice(0, n)), (lambda x: x)
    from packppi_torch.parallel.mesh import batch_rows, gather_rows

    return (lambda n: batch_rows(mesh, n)), (lambda x: gather_rows(mesh, x))


def padded_rows(n: int, mesh) -> int:
    """``n`` rounded up to a multiple of the ranks."""
    d = 1 if mesh is None else mesh.data
    return -(-n // d) * d


def bucket_indices(feats) -> dict:
    """Structure indices grouped by padded length bucket."""
    from packppi_torch.data.batch import bucket_length

    by_bucket: dict[int, list[int]] = {}
    for i, f in enumerate(feats):
        by_bucket.setdefault(bucket_length(len(f["residue_type"])), []).append(i)
    return by_bucket


def run_chunks(by_bucket: dict, per_chunk: int, dispatch, submit_writes,
               max_workers: int = 8) -> list:
    """The chunk loop: for each length bucket, take ``per_chunk`` structures
    at a time, pad the tail chunk with repeats of its last member, call
    ``dispatch(padded_indices, bucket)`` (the device pass, which returns host
    arrays), then ``submit_writes(pool, futures, chunk_indices, out)`` to
    queue the chunk's real members on the writer pool. Returns the write
    records in submission order; a writer that raised gives
    ``{"error": ...}``. An exception of ``dispatch`` propagates."""
    futures = []
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        for bucket, members in sorted(by_bucket.items()):
            for s in range(0, len(members), per_chunk):
                chunk = members[s:s + per_chunk]
                padded = chunk + [chunk[-1]] * (per_chunk - len(chunk))
                out = dispatch(padded, bucket)
                if out is not None:         # None: a rank other than 0
                    submit_writes(pool, futures, chunk, out)
        results = []
        for f in futures:
            try:
                results.append(f.result())
            except Exception as e:  # noqa: BLE001 (recorded, not hidden)
                traceback.print_exc()
                results.append({"error": f"{type(e).__name__}: {e}"})
        return results

"""Structure-analysis harness: the packing metric suite and external tools.

Equivalent of the reference's ProteinAnalysis (reference:
src/utils/protein_analysis.py:12-140). External binaries (MolProbity
clashscore, SCWRL4, FASPR) are optional host subprocesses; without the
MolProbity binary the clashscore is the native H-aware count
(``utils.metrics.probe_clashscore``), flagged ``clashscore_is_exact=False``.

Everything here runs on the host: the one tensor computation, the atom14
rebuild in ``get_metric``, is given the CPU by name, so metric threads that
run beside a packing loop never queue work on the card's stream.
"""
from __future__ import annotations

import re
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from packppi_torch.structure.featurize import featurize
from packppi_torch.structure.interface import interface_residue_mask
from packppi_torch.structure.protein import from_pdb_file
from packppi_torch.utils.logging import get_logger
from packppi_torch.utils.metrics import chi_metrics, mean_squared_atom_deviation

log = get_logger(__name__)


def as_floats(metric: dict) -> dict:
    """A metric suite as the JAX package writes it on every surface
    (``metrics.json``, directory mode's summary, the server's response):
    each number a float, booleans included (``clashscore_is_exact`` 0.0 or
    1.0); other values (a None clashscore) as they are."""
    return {k: (float(v) if isinstance(v, (int, float, np.floating, np.integer)) else v)
            for k, v in metric.items()}


class ProteinAnalysis:
    def __init__(self, molprobity_clash_loc: Optional[str] = None,
                 tmp_dir: str = ".packppi_tmp",
                 scwrl_loc: Optional[str] = None,
                 faspr_loc: Optional[str] = None):
        self.molprobity_clash_loc = molprobity_clash_loc
        self.scwrl_loc = scwrl_loc
        self.faspr_loc = faspr_loc
        self.tmp_dir = Path(tmp_dir)
        self.tmp_dir.mkdir(parents=True, exist_ok=True)

    def get_clashscore(self, pdb: str) -> Optional[float]:
        """MolProbity's clashscore by subprocess when the binary is given
        (None when its output holds no number); otherwise the native
        H-aware count of ``utils.metrics.probe_clashscore``."""
        if self.molprobity_clash_loc:
            out = subprocess.run(
                [self.molprobity_clash_loc, f"model={pdb}", "keep_hydrogens=True"],
                capture_output=True, text=True)
            m = re.search(r"clashscore\s*=\s*([0-9.]+)", out.stdout + out.stderr)
            return float(m.group(1)) if m else None
        from packppi_torch.utils.metrics import probe_clashscore
        return probe_clashscore(from_pdb_file(pdb, mse_to_met=True))

    def get_metric(self, true_pdb: str, pred_pdb: str,
                   strict_parity: bool = True) -> Optional[dict]:
        """The packing metric suite between an experimental structure and a
        repacked prediction: chi accuracy and AE, total and interface
        accuracy, ``atom_rmsd``, ``clashscore`` and ``clashscore_is_exact``.
        None when the two structures differ in residue count.

        ``strict_parity=False`` opts out of the reference's quirks: chi
        accuracy on the periodicity-folded error (exact matches count) and
        ``atom_rmsd`` as a true RMSD (``utils.metrics``)."""
        import torch

        from packppi_torch.geometry import atom14_coords_from_torsions

        true_prot = from_pdb_file(true_pdb, mse_to_met=True)
        pred_prot = from_pdb_file(pred_pdb, mse_to_met=True)
        ft = featurize(true_prot)
        fp = featurize(pred_prot)
        if ft["X"].shape[0] != fp["X"].shape[0]:
            log.warning("residue count mismatch between true and predicted structures")
            return None

        interface = interface_residue_mask(true_prot) * ft["residue_mask"]
        metric = chi_metrics(ft["SC_D"], fp["SC_D"], ft["SC_D_mask"],
                             ft["chi_1pi_periodic_mask"], interface,
                             strict_parity=strict_parity)
        metric = {k: float(v) for k, v in metric.items()}

        # the predicted chis rebuilt on the true backbone, on the CPU by name
        cpu = torch.device("cpu")
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cpu)
        with torch.no_grad():
            pred_coords = atom14_coords_from_torsions(
                f32(ft["X"]), torch.as_tensor(ft["residue_type"], dtype=torch.int64, device=cpu),
                f32(ft["BB_D"]), f32(fp["SC_D"]))
        metric["atom_rmsd"] = mean_squared_atom_deviation(
            ft["X"], pred_coords.numpy(), ft["atom_mask"], ft["residue_mask"],
            strict_parity=strict_parity)

        clashscore = self.get_clashscore(pred_pdb)
        metric["clashscore"] = clashscore
        # exact only when the binary gave a number: a failed parse is None
        metric["clashscore_is_exact"] = (self.molprobity_clash_loc is not None
                                         and clashscore is not None)
        return metric

    def run_tool(self, in_pdb: str, tool_name: str) -> Optional[dict]:
        """Run an external side-chain packer and score its output with the
        same suite (comparison baselines; reference:
        src/utils/protein_analysis.py:124-140)."""
        out_pdb = Path(self.tmp_dir) / "baseline.pdb"
        # the packers give no useful exit codes, so a fresh file is the only
        # sign of success: a stale one from an earlier call must never count
        out_pdb.unlink(missing_ok=True)
        exe = {"scwrl": self.scwrl_loc, "faspr": self.faspr_loc}.get(tool_name)
        if not exe:
            raise ValueError(f"tool {tool_name!r} not configured")
        proc = subprocess.run([exe, "-i", in_pdb, "-o", str(out_pdb)],
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        if not out_pdb.exists():
            err = (proc.stderr or b"").decode(errors="replace")[-500:]
            raise RuntimeError(f"{tool_name} produced no output for {in_pdb}"
                               + (f": {err}" if err.strip() else ""))
        return self.get_metric(in_pdb, str(out_pdb))

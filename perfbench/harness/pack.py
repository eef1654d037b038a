"""Traffic of kind "pack": PackPPI-MSC side-chain packing, closed loop, one
client, as ``cli.pack`` runs it (one complex, ``--use_proximal``) or as its
directory mode runs a chunk (``--input dir --batch_size B --n_samples N
--use_proximal``).

A request is a chunk of ``per_chunk`` copies of one complex, drawn from the
mix's complexes in blocks that hold each complex once, in an order drawn
from the seed, so every seed does the same work in another order. Each
chunk: parse and featurize the PDB text held in memory, stack the rows
(each complex ``n_samples`` times) at the complex's length bucket, sample
the chis (``TorsionalDiffusion.sample``), keep each complex's least clashing
row (``compute_residue_clash``), refine the winners (``cli.pack._refine``),
rebuild atom14 coordinates, read them back once and write PDB text.
"""
from __future__ import annotations

import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from perfbench.harness import common, costs, weights
from perfbench.harness.check import Checks, Sample


class Cell:
    LIBRARIES = ("message", "chain", "clash")

    def __init__(self, spec: dict, seed: int, device, faults=()):
        import torch

        self.torch, self.spec, self.seed, self.device = torch, spec, seed, device
        self.cfg, self.mix = spec["config"], spec["traffic"]
        self.faults = set(faults)
        self.spans = common.Spans()
        self.texts = [(common.BENCH / "data" / f).read_text() for f in self.mix["complexes"]]
        self.rng = np.random.default_rng(seed % 2 ** 63)
        self.order: list = []
        self.records: list = []
        self.sample = Sample(self.mix["check_chunks"] - 1, seed,
                             ("batch", "traj", "sc", "win", "scw", "ref", "pdb"))

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        torch = self.torch
        from packppi_torch.models import NetworkConfig, SampleConfig, TorsionalDiffusion
        from packppi_torch.structure import featurize, from_pdb_string

        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from packppi_torch.ops import _build
            _build.build_all(self.LIBRARIES)
        t1 = time.perf_counter()
        c = self.cfg
        net = NetworkConfig(
            node_features=c["node_features"], edge_features=c["edge_features"],
            hidden_dim=c["hidden_dim"], num_mpnn_layers=c["num_mpnn_layers"],
            n_points=c["n_points"], top_k=c["top_k"], dropout=c["dropout"], act=c["act"],
            compute_dtype=self.mix["precision"], **c["inference"])
        gen = torch.Generator(device=self.device).manual_seed(self.seed % 2 ** 63)
        self.state = weights.make(weights.score_net_shapes(c), gen, self.device)
        r, smp = c["refinement"], c["sampler"]
        sample_cfg = SampleConfig(annealed_temp=smp["annealed_temp"], mode=smp["mode"],
                                  violation_tolerance_factor=r["violation_tolerance_factor"],
                                  clash_overlap_tolerance=r["clash_overlap_tolerance"],
                                  lamda=r["lamda"], num_steps=r["num_steps"])
        self.model = TorsionalDiffusion(net, sample_cfg).to(self.device)
        self.model.net.load_state_dict(self.state, strict=True)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed % 2 ** 63 + 1)
        self.pool = ThreadPoolExecutor(max_workers=self.mix["host_threads"])
        self.writers = ThreadPoolExecutor(max_workers=self.mix["host_threads"])
        if "sampler_frozen" in self.faults:
            for sched in (self.model.schedule_pi, self.model.schedule_2pi):
                object.__setattr__(sched, "step", lambda x, *a, **k: x)
        self.lengths = [len(featurize(from_pdb_string(t, mse_to_met=True))["residue_type"])
                        for t in self.texts]
        t2 = time.perf_counter()
        # every shape of the mix, once
        warm = []
        for ci in range(len(self.texts)):
            t = time.perf_counter()
            self.drain([self.run_chunk(ci, keep=False)])
            warm.append(time.perf_counter() - t)
        print("setup: warm-up requests " + ", ".join(f"{w:.3f}" for w in warm) + " s",
              file=sys.stderr)
        common.log_setup(build=t1 - t0, model=t2 - t1, warm=time.perf_counter() - t2)

    # -- the stream -----------------------------------------------------------
    def next_complex(self) -> int:
        if not self.order:
            self.order = list(self.rng.permutation(len(self.texts)))
        return int(self.order.pop(0))

    def run_chunk(self, ci: int, keep: bool = True) -> dict:
        """One request: returns its record (completion in ``done``)."""
        torch = self.torch
        from packppi_torch.cli._directory import merge_output_structure
        from packppi_torch.cli.pack import _refine
        from packppi_torch.data import ProteinBatch, stack_batch
        from packppi_torch.data.batch import bucket_length
        from packppi_torch.geometry import atom14_coords_from_torsions
        from packppi_torch.ops.clash import compute_residue_clash
        from packppi_torch.structure import featurize, from_pdb_string, to_pdb

        mix, dev = self.mix, self.device
        n, ns = mix["per_chunk"], mix["n_samples"]
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" and mix["sync_spans"] else None
        rec = {"ci": ci, "t0": time.perf_counter(), "L": self.lengths[ci]}
        with self.spans("featurize"):
            texts = [self.texts[ci]] * n
            if n == 1:
                prots = [from_pdb_string(texts[0], mse_to_met=True)]
                feats = [featurize(prots[0])]
            else:
                prots = list(self.pool.map(lambda t: from_pdb_string(t, mse_to_met=True), texts))
                feats = list(self.pool.map(featurize, prots))
            if "feature_chi_zero" in self.faults:
                feats = [dict(f, SC_D=f["SC_D"] * 0) for f in feats]
            batch = stack_batch([f for f in feats for _ in range(ns)], dev,
                                target_len=bucket_length(rec["L"]))
        with self.spans("sample", sync):
            sc, traj = self.model.sample(batch, self.generator, n_steps=self.cfg["sampler"]["n_steps"],
                                         return_trajectory=True)
        with self.spans("pick"):
            base = torch.arange(n, device=dev) * ns
            win = base
            if ns > 1:
                with torch.no_grad():
                    clash = (compute_residue_clash(batch, sc) * batch.residue_mask).sum(-1)
                worst = "pick_worst" in self.faults
                win = base + (clash.view(n, ns).argmax(1) if worst else clash.view(n, ns).argmin(1))
            wb = ProteinBatch(*(t.index_select(0, base) for t in batch))
            scw = sc.index_select(0, win)
        with self.spans("refine", sync):
            if "refine_skipped" in self.faults:
                ref = scw
                accept = torch.zeros(n, dtype=torch.bool, device=dev)
            else:
                rows = n // 2 if "half_batch" in self.faults else n
                part = ProteinBatch(*(t[:rows] for t in wb))
                r, accept, _, _ = _refine(self.model, part, scw[:rows])
                ref = torch.cat([r, scw[rows:]]) if rows < n else r
            accept.cpu()                         # the read-back that waits for the device
        with self.spans("rebuild"), torch.no_grad():
            rebuilt = scw if "write_unrefined" in self.faults else ref
            coords = atom14_coords_from_torsions(wb.X, wb.residue_type, wb.BB_D, rebuilt).cpu().numpy()
            atom_mask = wb.atom_mask.cpu().numpy()

        def write(r):
            out = merge_output_structure(prots[r], feats[r], atom_mask[r:r + 1], coords[r:r + 1],
                                         rec["L"])
            return to_pdb(out)

        if n == 1:
            with self.spans("write"):
                rec["pdb"] = [write(0)]
            rec["done"] = time.perf_counter()
        else:
            rec["futures"] = [self.writers.submit(write, r) for r in range(n)]
        if keep:
            rec.update(batch=batch, traj=traj, sc=sc, win=win, scw=scw, ref=ref)
        return rec

    def drain(self, recs=()) -> None:
        """Wait for the writes of ``recs``; each chunk is done when its last
        PDB text is."""
        for rec in recs:
            if "futures" in rec:
                rec["pdb"] = [f.result() for f in rec.pop("futures")]
                rec["done"] = time.perf_counter()

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> dict:
        """Closed loop until ``seconds`` have passed; every request started
        in that time is finished and counted."""
        self.spans.seconds.clear()
        t0 = time.perf_counter()
        pending = []
        while time.perf_counter() - t0 < seconds:
            rec = self.run_chunk(self.next_complex())
            self.records.append(rec)
            pending.append(rec)
            with self.spans("write_wait"):
                while len(pending) > 1:          # one chunk's writes overlap the next
                    self.drain(pending[:1])
                    self.sample.offer(pending.pop(0))
        with self.spans("write_wait"):
            self.drain(pending)
        for rec in pending:
            self.sample.offer(rec)
        end = max(r["done"] for r in self.records)
        n = self.mix["per_chunk"]
        for ci, name in enumerate(self.mix["complexes"]):
            lat = sorted(r["done"] - r["t0"] for r in self.records if r["ci"] == ci)
            if lat:
                print(f"latency {name}: {len(lat)} requests, min {lat[0]:.4f} median "
                      f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f} s", file=sys.stderr)
        rows, steps = n * self.mix["n_samples"], self.cfg["sampler"]["n_steps"]
        return {"seconds": end - t0,
                "latencies": sorted(r["done"] - r["t0"] for r in self.records),
                "flops": sum(rows * steps * costs.score_net_flops(r["L"], self.cfg)
                             for r in self.records),
                "residues": sum(n * r["L"] for r in self.records),
                "items": len(self.records) * n, "peak": costs.PEAK_OPS_PER_S[self.mix["precision"]]}

    def traced(self) -> list:
        """The work of ``trace_chunks`` more requests (one block of the mix)
        for the profiler: [(evaluations, B, L, cfg, dtype, edge passes)]."""
        from packppi_torch.data.batch import bucket_length

        recs = []
        for _ in range(self.mix["trace_chunks"]):
            recs.append(self.run_chunk(self.next_complex(), keep=False))
            with self.spans("write_wait"):
                self.drain(recs[-2:-1])
        with self.spans("write_wait"):
            self.drain(recs[-1:])
        rows = self.mix["per_chunk"] * self.mix["n_samples"]
        return [(self.cfg["sampler"]["n_steps"], rows, bucket_length(r["L"]), self.cfg,
                 self.mix["precision"], self.cfg["num_mpnn_layers"] - 1) for r in recs]

    def release(self) -> None:
        """Free the program's state; what the check reads stays."""
        self.pool.shutdown(wait=True)
        self.writers.shutdown(wait=True)
        del self.model
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the comparison with the plain reference ---------------------------------
    def check(self, control=None) -> Checks:
        """Each stage of the sampled requests against the reference, given
        the program's state entering it: features from the PDB text, the
        sampler's steps (``step_gap``: the RMS gap of the program's steps
        from the reference's over all steps and chis of the chunk, in units of
        the gap that rounding the reference's products to bfloat16 makes at
        the same inputs), the pick of the least clashing sample, the
        refinement of the picked chis (largest chi gap, rad) and the PDB text
        (largest atom gap, A).
        ``control``: a rounding put in the network's place (the control run);
        its step gaps are read at the program's recorded inputs."""
        torch = self.torch
        from perfbench.reference import net as rn, pack as rp, precision as rq, structure as rs

        checks = Checks(self.mix["limits"])
        n, ns = self.mix["per_chunk"], self.mix["n_samples"]
        times, dts = rp.sampler_times(self.cfg["sampler"]["n_steps"])
        ref_p = rn.Params(self.state)
        floor_p = rn.Params(self.state, rq.bf16)
        low_p = rn.Params(self.state, control) if control is not None else None
        for rec in self.sample.records():
            parsed = rs.parse_pdb(self.texts[rec["ci"]])
            f = rs.featurize(parsed)
            rows = rs.batch([f] * (n * ns), rec["batch"].X.shape[1], self.device)
            checks.add("feature_gap", _feature_gap(rec["batch"], rows))
            m = rows["pi"] | rows["twopi"]
            nxt = list(rec["traj"][1:]) + [rec["sc"]]
            err = floor = worst = 0.0
            with torch.no_grad():
                g0, gf = rn.static_graph(ref_p, rows), rn.static_graph(floor_p, rows)
                gl = rn.static_graph(low_p, rows) if low_p is not None else None
                for s in range(len(times)):
                    t = torch.full(rows["rmask"].shape, float(times[s]), device=self.device)
                    x, step = rec["traj"][s], (float(times[s]), float(dts[s]))
                    d_ref = rp.ode_delta(rn.score(ref_p, rows, x, t, g0)[0], *step) * m
                    d_floor = rp.ode_delta(rn.score(floor_p, rows, x, t, gf)[0], *step) * m
                    if low_p is None:
                        d = rp.wrap(nxt[s] - x) * m
                    else:
                        d = rp.ode_delta(rn.score(low_p, rows, x, t, gl)[0], *step) * m
                    e = rp.wrap(d - d_ref)
                    err += float((e * e).sum())
                    floor += float(((d_floor - d_ref) ** 2).sum())
                    worst = max(worst, float(e.norm() / d_ref.norm()))
                checks.add("step_gap", (err / max(floor, 1e-30)) ** 0.5)
                checks.note("step_rms", worst)
                if ns > 1:
                    c = (rp.residue_clash(rows, rec["sc"]) * rows["rmask"]).sum(-1).view(n, ns)
                    got = c.gather(1, (rec["win"] - torch.arange(n, device=self.device) * ns)[:, None])[:, 0]
                    checks.add("pick_gap", float(((got - c.amin(1)) / c.amin(1).clamp(min=1e-6)).max()))
            winners = {k: v[::ns] for k, v in rows.items()}
            r = self.cfg["refinement"]
            ref_sc, _ = rp.refine(winners, rec["scw"], r["num_steps"], r["lr"], r["lamda"])
            checks.add("refine_gap", float(rp.wrap(ref_sc - rec["ref"]).abs().max()))
            with torch.no_grad():
                want = rp.atom14(winners["X"], winners["aatype"], winners["bb"], rec["ref"]).cpu().numpy()
            mask = winners["atom_mask"].cpu().numpy()
            checks.add("pdb_gap", max(_pdb_gap(rec["pdb"][k], want[k], mask[k], parsed, f["rmask"])
                                      for k in range(n)))
        return checks


def _feature_gap(batch, rows) -> float:
    names = dict(X="X", atom_mask="atom_mask", residue_type="aatype", residue_mask="rmask",
                 residue_index="ridx", chain_indices="chain", BB_D="bb", BB_D_sincos="bb_sincos",
                 BB_D_mask="bb_mask", SC_D="sc", SC_D_sincos="sc_sincos", SC_D_mask="sc_mask",
                 chi_1pi_periodic_mask="pi", chi_2pi_periodic_mask="twopi")
    return max(float((getattr(batch, a).double() - rows[b].double()).abs().max())
               for a, b in names.items())


def _pdb_gap(pdb: str, want: np.ndarray, mask: np.ndarray, inp: dict, rmask: np.ndarray) -> float:
    """Largest distance (A) between an atom of the PDB text and the
    reference's: rebuilt atoms where the residue is modelled, the input's
    atoms where it is not (an incomplete backbone passes through). An atom
    present on one side only, or another residue type, counts as 1e3 A."""
    from perfbench.reference import structure as rs

    got = rs.parse_pdb(pdb)
    L = len(inp["aatype"])
    if len(got["aatype"]) != L or (got["aatype"] != inp["aatype"]).any():
        return 1e3
    modelled = rmask[:L, None] > 0
    want = np.where(modelled[..., None], want[:L], np.nan_to_num(inp["X"]))
    expect = np.where(modelled, mask[:L] > 0, inp["atom_mask"] > 0)
    present = np.isfinite(got["X"]).all(-1)
    if (present != expect).any():
        return 1e3
    return float((np.linalg.norm(np.nan_to_num(got["X"]) - want, axis=-1) * present).max())

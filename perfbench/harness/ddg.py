"""Traffic of kind "ddg": PackPPI-AP in network mode over the mutations of a
SKEMPI-format table, closed loop, as ``cli.ddg --eval_csv`` runs them: each
mutation's structure parsed from the PDB text held in memory and featurized
with its mutant twin (``skempi_features``), batches of ``batch_size``
mutations of one length bucket from ``BucketedLoader`` (its worker thread
prefetching), ``stack_affinity_batch``, ``AffinityModel.predict`` and the
read-back of the predictions. Epoch after epoch, each in an order drawn from
the seed: every epoch holds every mutation once, in batches of the same
sizes whatever the seed.
"""
from __future__ import annotations

import csv
import functools
import time

from perfbench.harness import common, costs, weights
from perfbench.harness.check import Checks, Sample


class Cell:
    LIBRARIES = ("message", "chain")

    def __init__(self, spec: dict, seed: int, device, faults=()):
        import torch

        self.torch, self.spec, self.seed, self.device = torch, spec, seed, device
        self.cfg, self.mix = spec["config"], spec["traffic"]
        self.faults = set(faults)
        self.spans = common.Spans()
        with open(common.BENCH / "data" / self.mix["table"], newline="") as f:
            rows = list(csv.DictReader(f, delimiter=";"))
        self.texts = {k: (common.BENCH / "data" / v).read_text()
                      for k, v in self.mix["structures"].items()}
        self.entries = [{"pdb": r["#Pdb"].split("_")[0], "mutstr": r["Mutation(s)_cleaned"]}
                        for r in rows]
        self.records: list = []
        self.sample = Sample(self.mix["check_batches"] - 1, seed, ("batch",))

    def setup(self) -> None:
        torch = self.torch
        from packppi_torch.data.batch import bucket_length
        from packppi_torch.data.loader import BucketedLoader
        from packppi_torch.data.skempi import parse_mutation, stack_affinity_batch
        from packppi_torch.models import NetworkConfig
        from packppi_torch.models.affinity import AffinityModel
        from packppi_torch.structure import from_pdb_string

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
        self.state.update(weights.make(weights.affinity_net_shapes(c), gen, self.device))
        model = AffinityModel(net, "network", strict_parity=c["strict_parity"])
        self.model = model.to(self.device)
        backbone = {k: v for k, v in self.state.items() if k in model.backbone.net.state_dict()}
        self.model.backbone.net.load_state_dict(backbone, strict=True)
        self.model.net.load_state_dict({k: v for k, v in self.state.items() if k not in backbone},
                                       strict=True)
        for e in self.entries:
            e["mutations"] = [parse_mutation(m) for m in e["mutstr"].split(",")]
        lengths = {k: len(from_pdb_string(t, mse_to_met=True).aaindex) for k, t in self.texts.items()}
        self.lengths = [lengths[e["pdb"]] for e in self.entries]
        cell = self

        class Mutations:
            def lengths(self):
                return cell.lengths

            def __len__(self):
                return len(cell.entries)

            def __getitem__(self, i):
                return cell.features(i)

        stack = functools.partial(stack_affinity_batch, device=self.device)
        self.loader = BucketedLoader(Mutations(), self.mix["batch_size"], shuffle=True,
                                     seed=self.seed % 2 ** 31, drop_last=False,
                                     prefetch=self.mix["prefetch"], stack_fn=stack)
        t2 = time.perf_counter()
        # every batch shape of an epoch, once
        shapes = {}
        for b in self.loader.plan():
            shapes.setdefault((len(b), bucket_length(self.lengths[b[0]])), b)
        for b in shapes.values():
            feats = [self.features(i) for i in b]
            self.predict(stack(feats, target_len=bucket_length(self.lengths[b[0]])))
        common.log_setup(build=t1 - t0, model=t2 - t1, warm=time.perf_counter() - t2)

    def features(self, i: int) -> dict:
        from packppi_torch.data.skempi import skempi_features
        from packppi_torch.structure import from_pdb_string

        e = self.entries[i]
        t0 = time.perf_counter()
        f = skempi_features(from_pdb_string(self.texts[e["pdb"]], mse_to_met=True), e["mutations"])
        if "feature_mutation_dropped" in self.faults:
            f["mut_mask"] = f["mut_mask"] * 0
        self.spans.seconds["featurize_item"].append(time.perf_counter() - t0)
        return f

    def predict(self, batch):
        torch = self.torch
        with torch.no_grad():
            if "half_batch" in self.faults and batch.ddg.shape[0] > 1:
                h = batch.ddg.shape[0] // 2
                ddg, inv = self.model.predict(type(batch)(*(t[:h] for t in batch)))
                ddg = torch.cat([ddg, ddg.mean().expand(batch.ddg.shape[0] - h)])
                inv = torch.cat([inv, inv.mean().expand(batch.ddg.shape[0] - h)])
            else:
                ddg, inv = self.model.predict(batch)
        return ddg.cpu().numpy(), inv.cpu().numpy()

    def batches(self):
        """The loader's batches with their dataset indices, epoch after epoch."""
        while True:
            plan = self.loader.plan()
            for idx, batch in zip(plan, self.loader):
                yield idx, batch

    def window(self, seconds: float) -> dict:
        self.spans.seconds.clear()
        t0 = time.perf_counter()
        it = self.batches()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            idx, batch = next(it)
            wait = time.perf_counter() - t
            with self.spans("predict"):
                ddg, inv = self.predict(batch)
            self.spans.seconds["loader_wait"].append(wait)
            self.records.append({"idx": idx, "ddg": ddg, "inv": inv, "L": batch.X.shape[1],
                                 "batch": batch})
            self.sample.offer(self.records[-1])
        it.close()
        end = time.perf_counter()
        n = sum(len(r["idx"]) for r in self.records)
        return {"seconds": end - t0, "items": n,
                "flops": sum(costs.affinity_flops(self.lengths[i], self.cfg)
                             for r in self.records for i in r["idx"]),
                "peak": costs.PEAK_OPS_PER_S[self.mix["precision"]]}

    def traced(self) -> list:
        it = self.batches()
        work = []
        for _ in range(self.mix["trace_batches"]):
            idx, batch = next(it)
            with self.spans("predict"):
                self.predict(batch)
            # two backbone and two mutation-stack evaluations a batch
            work.append((4, len(idx), batch.X.shape[1], self.cfg, self.mix["precision"],
                         self.cfg["num_mpnn_layers"] - 1))
        it.close()
        return work

    def release(self) -> None:
        del self.model, self.loader
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, control=None) -> Checks:
        """Every prediction of the sampled batches (the longest among them)
        against the reference's, as the largest gap over the largest
        reference magnitude of the batch; the features of each mutation
        against the reference's."""
        torch = self.torch
        from perfbench.reference import affinity as ra, net as rn, structure as rs

        checks = Checks(self.mix["limits"])
        p = rn.Params(self.state)
        low = rn.Params(self.state, control) if control is not None else None
        for rec in self.sample.records():
            wild, mutant = [], []
            for j in rec["idx"]:
                e = self.entries[j]
                parsed = rs.parse_pdb(self.texts[e["pdb"]])
                f = rs.featurize(parsed)
                mt = ra.mutant_features(parsed, f, [ra.parse_mutation(m) for m in e["mutstr"].split(",")])
                wild.append(f)
                mutant.append(dict(f, **mt))
            bw = rs.batch(wild, rec["L"], self.device)
            bm = rs.batch(mutant, rec["L"], self.device)
            checks.add("feature_gap", _gap(rec["batch"], bw, bm))
            with torch.no_grad():
                want = ra.ddg(p, bw, bm, bm["mut"])
                got = ra.ddg(low, bw, bm, bm["mut"]) if low is not None else \
                    tuple(torch.as_tensor(v, device=self.device) for v in (rec["ddg"], rec["inv"]))
            scale = max(float(want[0].abs().max()), float(want[1].abs().max()), 1e-6)
            checks.add("ddg_gap", max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale)
        return checks


def _gap(batch, wild: dict, mut: dict) -> float:
    """Largest difference between a field of the program's batch and the
    reference's."""
    pairs = dict(X=("X", wild), atom_mask=("atom_mask", wild), residue_type=("aatype", wild),
                 residue_mask=("rmask", wild), residue_index=("ridx", wild),
                 chain_indices=("chain", wild), BB_D=("bb", wild), BB_D_sincos=("bb_sincos", wild),
                 BB_D_mask=("bb_mask", wild), SC_D=("sc", wild), SC_D_sincos=("sc_sincos", wild),
                 SC_D_mask=("sc_mask", wild), residue_type_mut=("aatype", mut),
                 atom_mask_mut=("atom_mask", mut), SC_D_mut=("sc", mut),
                 SC_D_sincos_mut=("sc_sincos", mut), SC_D_mask_mut=("sc_mask", mut),
                 chi_1pi_periodic_mask_mut=("pi", mut), chi_2pi_periodic_mask_mut=("twopi", mut),
                 mut_mask=("mut", mut))
    return max(float((getattr(batch, a).double() - src[b].double()).abs().max())
               for a, (b, src) in pairs.items())

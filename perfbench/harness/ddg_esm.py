"""Traffic of kind "ddg_esm": PackPPI-AP in esm mode over the mutations of
SKEMPI-format tables, closed loop, as ``cli.ddg --eval_csv --mode esm``
runs them: each mutation's structure parsed from the PDB text held in
memory, mutated and tokenized (``esm_item``, on the loader's thread),
batches of ``batch_size`` mutations of one length bucket from
``BucketedLoader`` (prefetch), ``stack_esm_batch`` (each distinct sequence
once), ``EsmAffinityModel.predict`` (one ESM-2 forward, the head) and the
read-back of the predictions. Epoch after epoch, each in an order drawn
from the seed.

The weights are drawn on the device from the seed (``weights.make``'s
scheme, LayerNorm scales about 1) and handed to the program and to the
reference (``reference/esm2.py``) alike. Faults planted on purpose for the
tests of the comparison: ``esm_block_dropped`` (32 of the 33 blocks),
``mutant_not_embedded`` (the wild type's rows in the mutant's place),
``half_batch``.
"""
from __future__ import annotations

import csv
import math
import time

import numpy as np

from perfbench.harness import common, costs, costs_esm, weights
from perfbench.harness.check import Checks, Sample

FAULTS = ("esm_block_dropped", "mutant_not_embedded", "half_batch")


def esm_shapes(cfg: dict) -> dict:
    """ESM-2's parameters under HuggingFace ``EsmModel``'s names."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    out = {"embeddings.word_embeddings.weight": (cfg["vocab_size"], d)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            out[f"{pre}attention.self.{name}.weight"] = (d, d)
            out[f"{pre}attention.self.{name}.bias"] = (d,)
        out[f"{pre}attention.output.dense.weight"] = (d, d)
        out[f"{pre}attention.output.dense.bias"] = (d,)
        out[f"{pre}attention.LayerNorm.weight"] = (d,)
        out[f"{pre}attention.LayerNorm.bias"] = (d,)
        out[f"{pre}intermediate.dense.weight"] = (f, d)
        out[f"{pre}intermediate.dense.bias"] = (f,)
        out[f"{pre}output.dense.weight"] = (d, f)
        out[f"{pre}output.dense.bias"] = (d,)
        out[f"{pre}LayerNorm.weight"] = (d,)
        out[f"{pre}LayerNorm.bias"] = (d,)
    out["encoder.emb_layer_norm_after.weight"] = (d,)
    out["encoder.emb_layer_norm_after.bias"] = (d,)
    return out


def head_shapes(dim: int) -> dict:
    out = {}
    for i, n in ((0, dim), (2, dim), (4, 1)):
        out[f"ddg_predictor.{i}.weight"] = (n, dim)
        out[f"ddg_predictor.{i}.bias"] = (n,)
    return out


class Cell:
    LIBRARIES = ("attention",)

    def __init__(self, spec: dict, seed: int, device, faults=()):
        import torch

        self.torch, self.spec, self.seed, self.device = torch, spec, seed, device
        self.cfg, self.mix = spec["config"], spec["traffic"]
        self.faults = set(faults)
        unknown = self.faults - set(FAULTS)
        if unknown:
            raise ValueError(f"no fault {sorted(unknown)} in kind ddg_esm ({FAULTS})")
        self.spans = common.Spans()
        rows = []
        for table in self.mix["tables"]:
            with open(common.BENCH / "data" / table, newline="") as f:
                rows += list(csv.DictReader(f, delimiter=";"))
        self.texts = {k: (common.BENCH / "data" / v).read_text()
                      for k, v in self.mix["structures"].items()}
        self.entries = [{"pdb": r["#Pdb"].split("_")[0], "mutstr": r["Mutation(s)_cleaned"]}
                        for r in rows]
        self.records: list = []
        self.sample = Sample(self.mix["check_batches"] - 1, seed, ("batch", "wt", "mt"))
        self.embedded = None

    def setup(self) -> None:
        torch = self.torch
        # the program first: a checkout without esm mode's batch fails here, at once
        from packppi_torch.data.batch import bucket_length
        from packppi_torch.data.esm import esm_model
        from packppi_torch.data.loader import BucketedLoader
        from packppi_torch.data.skempi import esm_item, parse_mutation, stack_esm_batch
        from packppi_torch.models import NetworkConfig
        from packppi_torch.models.affinity import AffinityNet, EsmAffinityModel
        from packppi_torch.structure import from_pdb_string

        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from packppi_torch.ops import _build
            _build.build_all(self.LIBRARIES)
        t1 = time.perf_counter()
        c = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(self.seed % 2 ** 63)
        self.state = weights.make(esm_shapes(c), gen, self.device)
        for k, v in self.state.items():
            if "LayerNorm.weight" in k or "layer_norm_after.weight" in k:
                v.add_(1.0)                                    # 1 +- 0.1
        self.head_state = weights.make(head_shapes(c["head"]["esm_dim"]), gen, self.device)
        esm = esm_model({"vocab_size": c["vocab_size"], "hidden_size": c["hidden_size"],
                         "num_layers": c["num_hidden_layers"],
                         "num_heads": c["num_attention_heads"],
                         "intermediate_size": c["intermediate_size"],
                         "layer_norm_eps": c["layer_norm_eps"], "token_dropout": c["token_dropout"],
                         "mask_token_id": c["mask_token_id"], "pad_token_id": c["pad_token_id"],
                         "compute_dtype": c["compute_dtype"]}, self.state, self.device)
        net = AffinityNet(NetworkConfig(), "esm", c["head"]["strict_parity"],
                          esm_dim=c["head"]["esm_dim"])
        net.load_state_dict(self.head_state, strict=True)
        self.model = EsmAffinityModel(esm, net.to(self.device))
        if "esm_block_dropped" in self.faults:
            esm.encoder.layer = torch.nn.ModuleList(list(esm.encoder.layer)[:-1])
        embed = self.model.embed

        def embed_kept(batch):
            """The model's own ``embed``; its rows are kept for the check."""
            wt, mt = embed(batch)
            if "mutant_not_embedded" in self.faults:
                mt = wt
            self.embedded = (wt, mt)
            return wt, mt

        self.model.embed = embed_kept
        for e in self.entries:
            e["mutations"] = [parse_mutation(m) for m in e["mutstr"].split(",")]
        prots = {k: from_pdb_string(t, mse_to_met=True) for k, t in self.texts.items()}
        # a substitution keeps the token count: a complex's count is each of its sequences'
        self.tokens = {k: len(esm_item(p, [])["wt_tokens"]) for k, p in prots.items()}
        self.lengths = [len(prots[e["pdb"]].aaindex) for e in self.entries]
        buckets = {}
        for e, n in zip(self.entries, self.lengths):
            buckets.setdefault(bucket_length(n), set()).add(e["pdb"])
        if any(len(v) > 1 for v in buckets.values()):
            raise ValueError(f"two complexes share a length bucket: {buckets}")
        cell = self

        class Mutations:
            def lengths(self):
                return cell.lengths

            def __len__(self):
                return len(cell.entries)

            def __getitem__(self, i):
                return cell.item(i)

        self.stack = lambda items, target_len=None: stack_esm_batch(items, self.device)
        self.loader = BucketedLoader(Mutations(), self.mix["batch_size"], shuffle=True,
                                     seed=self.seed % 2 ** 31, drop_last=False,
                                     prefetch=self.mix["prefetch"], stack_fn=self.stack)
        t2 = time.perf_counter()
        # every batch shape of an epoch, once
        shapes = {}
        for b in self.loader.plan():
            shapes.setdefault((len(b), bucket_length(self.lengths[b[0]])), b)
        for b in shapes.values():
            self.predict(self.stack([self.item(i) for i in b]))
        common.log_setup(build=t1 - t0, model=t2 - t1, warm=time.perf_counter() - t2)

    def item(self, i: int) -> dict:
        from packppi_torch.data.skempi import esm_item
        from packppi_torch.structure import from_pdb_string

        e = self.entries[i]
        t0 = time.perf_counter()
        it = esm_item(from_pdb_string(self.texts[e["pdb"]], mse_to_met=True), e["mutations"])
        self.spans.seconds["featurize_item"].append(time.perf_counter() - t0)
        return it

    def predict(self, batch):
        torch = self.torch
        B = batch.ddg.shape[0]
        if "half_batch" in self.faults and B > 1:
            h = B // 2
            half = batch._replace(rows=batch.rows[:, :h], row_mask=batch.row_mask[:h],
                                  ddg=batch.ddg[:h])
            ddg, inv = self.model.predict(half)
            ddg = torch.cat([ddg, ddg.mean().expand(B - h)])
            inv = torch.cat([inv, inv.mean().expand(B - h)])
        else:
            ddg, inv = self.model.predict(batch)
        return ddg.cpu().numpy(), inv.cpu().numpy()

    def batches(self):
        """The loader's batches with their dataset indices, epoch after epoch."""
        while True:
            plan = self.loader.plan()
            for idx, batch in zip(plan, self.loader):
                yield idx, batch

    def flops(self, idx, batch) -> float:
        """The forward's operations on the true tokens of each distinct
        sequence of the batch (one complex a bucket, so one token count),
        and the head's."""
        n = self.tokens[self.entries[idx[0]]["pdb"]]
        return (batch.input_ids.shape[0] * costs_esm.esm_flops(n, self.cfg)
                + len(idx) * costs_esm.head_flops(self.cfg["head"]["esm_dim"]))

    def window(self, seconds: float) -> dict:
        self.spans.seconds.clear()
        t0 = time.perf_counter()
        it = self.batches()
        flops = 0.0
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            idx, batch = next(it)
            wait = time.perf_counter() - t
            with self.spans("predict"):
                ddg, inv = self.predict(batch)
            self.spans.seconds["loader_wait"].append(wait)
            wt, mt = self.embedded
            flops += self.flops(idx, batch)
            self.records.append({"idx": idx, "ddg": ddg, "inv": inv, "L": batch.rows.shape[2],
                                 "batch": batch, "wt": wt, "mt": mt})
            self.sample.offer(self.records[-1])
        it.close()
        end = time.perf_counter()
        self.embedded = None
        n = sum(len(r["idx"]) for r in self.records)
        return {"seconds": end - t0, "items": n, "flops": flops,
                "peak": costs.PEAK_OPS_PER_S[self.mix["precision"]]}

    def traced(self) -> list:
        it = self.batches()
        work = []
        for _ in range(self.mix["trace_batches"]):
            idx, batch = next(it)
            with self.spans("predict"):
                self.predict(batch)
            # one forward a batch over its distinct sequences
            work.append((1, batch.input_ids.shape[0], batch.input_ids.shape[1], self.cfg,
                         self.mix["precision"]))
        it.close()
        self.embedded = None
        return work

    def release(self) -> None:
        del self.model, self.loader
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, control=None) -> Checks:
        """For each sampled batch (the longest among them): the program's
        token rows and residue-row map against the reference's tokenization
        (``token_gap``), every residue row of every embedded sequence against
        the reference's forward of that sequence alone (``embed_gap``, over
        the batch's largest reference magnitude; padding rows against
        zeros), and each prediction and its twin against the reference's
        head on the reference's rows (``ddg_gap``). ``control`` puts the
        reference one precision down in the program's place."""
        torch = self.torch
        from perfbench.reference import affinity as ra, esm2 as rx, structure as rs

        c = self.cfg
        checks = Checks(self.mix["limits"])
        sound = rx.Params(self.state)
        low = rx.Params(self.state, control) if control is not None else None
        forward = {}

        def embed(p, ids):
            key = (p is low, ids.tobytes())
            if key not in forward:
                with torch.no_grad():
                    forward[key] = rx.forward(p, torch.as_tensor(ids, device=self.device),
                                              c["num_attention_heads"], c["num_hidden_layers"])
            return forward[key]

        parsed = {k: rs.parse_pdb(t) for k, t in self.texts.items()}
        feats = {k: rs.featurize(p) for k, p in parsed.items()}
        for rec in self.sample.records():
            B, L, d = len(rec["idx"]), rec["L"], c["hidden_size"]
            want = torch.zeros(2, B, L, d, device=self.device)
            got = torch.zeros_like(want) if low is not None else None
            ids_p = rec["batch"].input_ids.cpu().numpy()
            mask_p = rec["batch"].attention_mask.cpu().numpy()
            rows_p = rec["batch"].rows.cpu().numpy()
            R, T = ids_p.shape
            token_gap = 0.0
            for b, j in enumerate(rec["idx"]):
                e = self.entries[j]
                f = feats[e["pdb"]]
                mutated = rx.mutant_types(parsed[e["pdb"]],
                                          [ra.parse_mutation(m) for m in e["mutstr"].split(",")])
                n = len(f["aatype"])
                for side, aatype in enumerate((f["aatype"], mutated)):
                    ids, rows = rx.tokens(aatype, f["chain"])
                    token_gap = max(token_gap, _token_gap(ids, rows, ids_p, mask_p,
                                                          rows_p[side, b], n))
                    want[side, b, :n] = embed(sound, ids)[torch.as_tensor(rows, device=self.device)]
                    if low is not None:
                        got[side, b, :n] = embed(low, ids)[torch.as_tensor(rows, device=self.device)]
            checks.add("token_gap", token_gap)
            if low is None:
                got = (torch.stack([rec["wt"], rec["mt"]]).float()
                       if rec["wt"].shape == want.shape[1:] and rec["mt"].shape == want.shape[1:]
                       else None)
            scale = max(float(want.abs().max()), 1e-6)
            checks.add("embed_gap", math.inf if got is None else
                       float((got - want).abs().max()) / scale)
            head = rx.Params(self.head_state)
            with torch.no_grad():
                ref = rx.head(head, want[0], want[1])
                out = rx.head(rx.Params(self.head_state, control), got[0], got[1]) \
                    if low is not None else \
                    tuple(torch.as_tensor(v, device=self.device) for v in (rec["ddg"], rec["inv"]))
            scale = max(float(ref[0].abs().max()), float(ref[1].abs().max()), 1e-6)
            checks.add("ddg_gap", max(float((g - w).abs().max()) for g, w in zip(out, ref)) / scale)
        return checks


def _token_gap(ids, rows, ids_p, mask_p, rows_p, n) -> float:
    """0 when the program's batch holds the reference's token sequence
    ``ids`` as one of its rows, unpadded there and padded after it, and
    maps each of the n residues to the token the reference does (``rows``)
    and every padding residue to the zero row; else the largest id or
    index difference, or 1."""
    R, T = ids_p.shape
    r = int(rows_p[0]) // T
    if not 0 <= r < R or (rows_p[:n] // T != r).any() or (rows_p[n:] != R * T).any() \
            or int(mask_p[r].sum()) != len(ids) or (mask_p[r, len(ids):] != 0).any():
        return 1.0
    return float(max(np.abs(ids_p[r, :len(ids)] - ids).max(),
                     np.abs(rows_p[:n] - r * T - rows).max()))

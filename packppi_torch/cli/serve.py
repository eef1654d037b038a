"""packppi-torch-serve: a warm-model inference server (HTTP/JSON).

The sampler, the proximal refinement and (built at the first ``/ddg``) the
affinity model stay resident in one process, their weights on the device
across requests of any length bucket. Endpoints (JSON bodies in, JSON out;
a raw PDB body is taken as ``{"pdb": <body>}``):

  GET  /healthz -> {"status": "ok", "backend", "devices", "random_weights",
                    "n_steps", "buckets_warm", "endpoints"}
  POST /pack    -> {"pdb", "n_samples"?, "use_proximal"?, "seed"?, "metrics"?}
                   -> {"pdb": packed, "metrics"}
  POST /prox    -> {"pdb", "num_steps"?, "lamda"?, "violation_tolerance_factor"?,
                    "clash_overlap_tolerance"?, "metrics"?} -> {"pdb": refined, "metrics"}
  POST /ddg     -> {"pdb", "mutstr": "KI15G[,..]"} -> {"ddg_pred", "mutstr",
                    "random_weights"}

A client error answers 400 (404 for an unknown path, 413 for a body over
``--max_body_mb``), a failure inside a request 500, each with ``{"error"}``.
The JSON contract, the status codes and the limits are the JAX package's
``packppi-serve``.

Concurrency: handler threads (``ThreadingHTTPServer``) parse, featurize and
write PDBs freely; one ``device_lock`` serializes all device work, so
kernel launches of two requests never interleave on the device's stream.
Each request draws from a ``torch.Generator`` of its own: seeded with the
request's ``seed``, or with a seed drawn from the session's stream under
``_key_lock``. A seeded ``/pack`` writes what ``cli.pack`` writes with the
same seed and weights. The metric suite runs on the handler thread on CPU
copies only.

    python -m packppi_torch.cli.serve [--ckpt weights.pt] [--affinity_ckpt affinity.pt]
        [--pre_ckpt backbone.pt] [--port 8642] [--n_steps 30] [--precision bfloat16]
        [--no_fused] [--geometry global|local] [--warmup PDB] [--device cuda|cpu]

Runs on the CUDA device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import torch

MAX_BODY_DRAIN = 64 * 1024 * 1024


def build_parser():
    p = argparse.ArgumentParser(description="PackPPI inference server (PyTorch/CUDA)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8642,
                   help="TCP port (0 = pick a free port, printed on start)")
    p.add_argument("--ckpt", default=None, help="diffusion weights (packing)")
    p.add_argument("--affinity_ckpt", default=None, help="affinity network weights")
    p.add_argument("--pre_ckpt", default=None,
                   help="frozen diffusion backbone for /ddg (defaults to --ckpt)")
    p.add_argument("--n_steps", type=int, default=30, help="reverse-diffusion steps")
    p.add_argument("--precision", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--no_fused", action="store_true",
                   help="run the network without its kernels (see cli.pack)")
    p.add_argument("--geometry", default="global", choices=["global", "local"])
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--molprobity_loc", default=None)
    p.add_argument("--warmup", default=None, metavar="PDB",
                   help="pack this structure once at startup")
    p.add_argument("--max_body_mb", type=int, default=16,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--tmp_dir", default=None,
                   help="scratch directory of the metric suite "
                        "(default: <cwd>/packppi_serve_tmp)")
    return p


class ServeError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class PackSession:
    """The resident sampler on the device. Device work goes through
    ``device_lock``."""

    MAX_SAMPLES = 32     # bounds the device memory a request can ask for

    def __init__(self, args):
        from packppi_torch.cli.pack import _model
        from packppi_torch.device import resolve_device

        self.args = args
        self.device = resolve_device(args.device)
        self.device_lock = threading.Lock()
        self._key_lock = threading.Lock()
        self._stream = torch.Generator().manual_seed(args.seed)
        # refuses a configuration the device cannot run, before any request
        self.model = _model(args, self.device)
        self.random_weights = not args.ckpt
        self.buckets_seen: list[int] = []

    def generator(self, seed=None) -> torch.Generator:
        """The request's generator: from its seed, or from the session's stream."""
        if seed is None:
            with self._key_lock:
                seed = int(torch.randint(2 ** 62, (1,), generator=self._stream))
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _featurize(self, pdb_text: str):
        from packppi_torch.structure import featurize, from_pdb_string

        prot = from_pdb_string(pdb_text, mse_to_met=True)
        return prot, featurize(prot)

    def _on_device(self, batch):
        return type(batch)(*(t.to(self.device) for t in batch))

    def pack(self, pdb_text: str, n_samples: int = 1, use_proximal: bool = False,
             seed=None, want_metrics: bool = True) -> dict:
        """The ``n_samples`` samples of the structure, the least clashing
        kept, refined with ``use_proximal``; its PDB and metrics."""
        from packppi_torch.cli._directory import merge_output_structure
        from packppi_torch.cli.pack import _refine
        from packppi_torch.data import ProteinBatch, stack_batch
        from packppi_torch.geometry import atom14_coords_from_torsions
        from packppi_torch.ops.clash import compute_residue_clash
        from packppi_torch.structure import to_pdb

        if not 1 <= int(n_samples) <= self.MAX_SAMPLES:
            raise ServeError(400, f"n_samples must be in [1, {self.MAX_SAMPLES}]")
        n_samples = int(n_samples)
        prot, feats = self._featurize(pdb_text)
        host_batch = stack_batch([feats] * n_samples, "cpu")
        L_bucket = int(host_batch.residue_type.shape[1])
        with self._key_lock:          # buckets_seen shares the small-state lock
            if L_bucket not in self.buckets_seen:
                self.buckets_seen.append(L_bucket)
        generator = self.generator(seed)

        t0 = time.perf_counter()
        with self.device_lock:
            batch = self._on_device(host_batch)
            sc = self.model.sample(batch, generator, n_steps=self.args.n_steps)
            with torch.no_grad():
                clash = (compute_residue_clash(batch, sc) * batch.residue_mask).sum(-1)
            best = int(clash.argmin())
            batch = ProteinBatch(*(t[best:best + 1] for t in batch))
            sc = sc[best:best + 1]
            accepted = None
            if use_proximal:
                sc, accept, _, _ = _refine(self.model, batch, sc)
                accepted = bool(accept[0])
            with torch.no_grad():
                coords = atom14_coords_from_torsions(batch.X, batch.residue_type, batch.BB_D, sc)
            coords, atom_mask = coords.cpu().numpy(), batch.atom_mask.cpu().numpy()
        t_device = time.perf_counter() - t0

        L = len(feats["residue_type"])
        out_text = to_pdb(merge_output_structure(prot, feats, atom_mask, coords, L))
        metrics = {"device_seconds": t_device, "n_samples": n_samples,
                   "length_bucket": L_bucket, "random_weights": self.random_weights}
        if use_proximal:
            metrics["proximal_accepted"] = accepted
        if want_metrics and feats["SC_D_mask"].sum() > 0:
            metrics.update(self._metric_suite(pdb_text, out_text))
        return {"pdb": out_text, "metrics": metrics}

    def prox(self, pdb_text: str, num_steps: int = 50, lamda: float = 1.0,
             violation_tolerance_factor: float = 12.0, clash_overlap_tolerance: float = 0.5,
             want_metrics: bool = True) -> dict:
        """The proximal refinement of the structure's own chis, accepted when
        the objective fell; its PDB and metrics."""
        from packppi_torch.cli._directory import merge_output_structure
        from packppi_torch.cli.prox import _optimize
        from packppi_torch.data import stack_batch
        from packppi_torch.structure import to_pdb

        if not 1 <= int(num_steps) <= 1000:
            raise ServeError(400, "num_steps must be in [1, 1000]")
        prot, feats = self._featurize(pdb_text)
        if feats["SC_D_mask"].sum() == 0:
            raise ServeError(400, "input structure has no side-chain chi angles to optimize")
        host_batch = stack_batch([feats], "cpu")
        opts = SimpleNamespace(num_steps=int(num_steps), lamda=float(lamda),
                               violation_tolerance_factor=float(violation_tolerance_factor),
                               clash_overlap_tolerance=float(clash_overlap_tolerance))
        t0 = time.perf_counter()
        with self.device_lock:
            batch = self._on_device(host_batch)
            coords, accept, first, last = _optimize(opts, batch)
            coords, atom_mask = coords.cpu().numpy(), batch.atom_mask.cpu().numpy()
            accepted, first, last = bool(accept[0]), float(first[0]), float(last[0])
        t_device = time.perf_counter() - t0

        L = len(feats["residue_type"])
        out_text = to_pdb(merge_output_structure(prot, feats, atom_mask, coords, L))
        metrics = {"device_seconds": t_device, "accepted": accepted,
                   "objective_initial": first, "objective_final": last}
        if want_metrics:
            for key, text in (("clashscore_before", pdb_text), ("clashscore_after", out_text)):
                value = self._clashscore(text)
                if value is not None:
                    metrics[key] = value
        return {"pdb": out_text, "metrics": metrics}

    # -- the metric suite is path-based: temporary files, CPU copies only --
    def _analysis(self):
        from packppi_torch.utils.analysis import ProteinAnalysis

        tmp = Path(self.args.tmp_dir or "packppi_serve_tmp")
        return ProteinAnalysis(self.args.molprobity_loc, tmp_dir=str(tmp)), tmp

    def _tmp_pdb(self, tmp: Path, tag: str, text: str) -> Path:
        path = tmp / f"{tag}_{threading.get_ident()}_{time.monotonic_ns()}.pdb"
        path.write_text(text)
        return path

    def _metric_suite(self, true_text: str, pred_text: str) -> dict:
        from packppi_torch.utils.analysis import as_floats

        analysis, tmp = self._analysis()
        paths = [self._tmp_pdb(tmp, "true", true_text), self._tmp_pdb(tmp, "pred", pred_text)]
        try:
            return as_floats(analysis.get_metric(*map(str, paths)) or {})
        finally:
            for p in paths:
                p.unlink(missing_ok=True)

    def _clashscore(self, pdb_text: str):
        analysis, tmp = self._analysis()
        path = self._tmp_pdb(tmp, "cs", pdb_text)
        try:
            return analysis.get_clashscore(str(path))
        finally:
            path.unlink(missing_ok=True)


class DdgSession:
    """The affinity model on the device, built at the first ``/ddg``
    (``cli.ddg``'s network mode: the backbone from ``--pre_ckpt`` or
    ``--ckpt``, the affinity network from ``--affinity_ckpt``)."""

    def __init__(self, args, device, device_lock):
        from packppi_torch.cli.ddg import _affinity_model

        self.device, self.device_lock = device, device_lock
        pre = args.pre_ckpt or args.ckpt
        self.random_weights = not (pre and args.affinity_ckpt)
        self.model = _affinity_model(SimpleNamespace(
            mode="network", no_strict_parity=False, pre_ckpt=pre, ckpt=args.affinity_ckpt,
            seed=args.seed), device)

    def ddg(self, pdb_text: str, mutstr: str) -> dict:
        from packppi_torch.data.skempi import (AffinityBatch, parse_mutation, skempi_features,
                                               stack_affinity_batch)
        from packppi_torch.structure import from_pdb_string

        prot = from_pdb_string(pdb_text, mse_to_met=True)
        mutations = [parse_mutation(m.strip()) for m in mutstr.split(",")]
        host_batch = stack_affinity_batch([skempi_features(prot, mutations)], "cpu")
        with self.device_lock, torch.no_grad():
            batch = AffinityBatch(*(t.to(self.device) for t in host_batch))
            value = float(self.model.predict(batch)[0][0])
        return {"ddg_pred": value, "mutstr": mutstr, "random_weights": self.random_weights}


def _as_num(req: dict, key, default, lo, hi, cast=float):
    """A client's numeric field, checked: garbage or out of range is a 400."""
    val = req.get(key, default)
    try:
        val = cast(val)
    except (TypeError, ValueError):
        raise ServeError(400, f"'{key}' must be a number")
    if not lo <= val <= hi:
        raise ServeError(400, f"'{key}' must be in [{lo}, {hi}]")
    return val


def _backend(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.get_device_name(device), torch.cuda.device_count()
    return "cpu", 1


def make_handler(sessions: dict, args):
    ddg_init_lock = threading.Lock()

    def get_ddg_session():
        # one constructor, never beside an in-flight device dispatch
        with ddg_init_lock:
            if "ddg" not in sessions:
                pack = sessions["pack"]
                with pack.device_lock:
                    sessions["ddg"] = DdgSession(args, pack.device, pack.device_lock)
        return sessions["ddg"]

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):   # no access log
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code >= 400:
                # an error may leave an unread body: close rather than let
                # its bytes be read as the next request
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": f"unknown path {self.path}"})
            s = sessions["pack"]
            backend, devices = _backend(s.device)
            with s._key_lock:
                buckets = list(s.buckets_seen)
            self._reply(200, {
                "status": "ok", "backend": backend, "devices": devices,
                "random_weights": s.random_weights, "n_steps": args.n_steps,
                "buckets_warm": buckets,
                "endpoints": ["/healthz", "/pack", "/prox", "/ddg"]})

        def _read_request(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                raise ServeError(400, "empty request body")
            if n > args.max_body_mb * 1024 * 1024:
                # never read a client-sized body into memory: drain it in
                # small chunks up to a cap (so a client that writes first
                # still sees the 413), then drop the connection
                left = min(n, MAX_BODY_DRAIN)
                while left > 0:
                    chunk = self.rfile.read(min(left, 65536))
                    if not chunk:
                        break
                    left -= len(chunk)
                self.close_connection = True
                raise ServeError(413, f"request body {n} bytes exceeds "
                                      f"--max_body_mb={args.max_body_mb}")
            raw = self.rfile.read(n)
            try:
                req = json.loads(raw)
            except json.JSONDecodeError:
                req = {"pdb": raw.decode("utf-8", "replace")}    # a raw PDB body
            if not isinstance(req, dict) or not req.get("pdb"):
                raise ServeError(400, "body must be JSON with a 'pdb' field (or raw PDB text)")
            return req

        def do_POST(self):
            try:
                req = self._read_request()
                if self.path == "/pack":
                    out = sessions["pack"].pack(
                        req["pdb"],
                        n_samples=_as_num(req, "n_samples", 1, 1, PackSession.MAX_SAMPLES, int),
                        use_proximal=bool(req.get("use_proximal", False)),
                        seed=req.get("seed"),
                        want_metrics=bool(req.get("metrics", True)))
                elif self.path == "/prox":
                    out = sessions["pack"].prox(
                        req["pdb"],
                        num_steps=_as_num(req, "num_steps", 50, 1, 1000, int),
                        lamda=_as_num(req, "lamda", 1.0, 0.0, 1e6),
                        violation_tolerance_factor=_as_num(
                            req, "violation_tolerance_factor", 12.0, 0.0, 1e6),
                        clash_overlap_tolerance=_as_num(
                            req, "clash_overlap_tolerance", 0.5, 0.0, 10.0),
                        want_metrics=bool(req.get("metrics", True)))
                elif self.path == "/ddg":
                    if not req.get("mutstr"):
                        raise ServeError(400, "/ddg needs a 'mutstr' field")
                    out = get_ddg_session().ddg(req["pdb"], req["mutstr"])
                else:
                    raise ServeError(404, f"unknown path {self.path}")
                self._reply(200, out)
            except ServeError as e:
                self._reply(e.code, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 (the HTTP contract: a failed request is a 500)
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(args, sessions=None) -> ThreadingHTTPServer:
    """The HTTP server over a warm ``PackSession`` (not started)."""
    sessions = sessions if sessions is not None else {}
    sessions["pack"] = PackSession(args)
    if args.warmup:
        t0 = time.perf_counter()
        sessions["pack"].pack(Path(args.warmup).read_text(), want_metrics=False)
        print(f"warmup pack done in {time.perf_counter() - t0:.1f}s")
    return ThreadingHTTPServer((args.host, args.port), make_handler(sessions, args))


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = make_server(args)
    host, port = server.server_address[:2]
    print(f"packppi-torch-serve listening on http://{host}:{port} "
          "(POST /pack /prox /ddg, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()

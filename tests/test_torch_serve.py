"""``packppi_torch.cli.serve`` in-process on the CPU, driven over HTTP.

The eight tests of ``tests/test_serve.py`` run against the port's server
(``--device cpu``, random weights from seed 0, two steps, float32). Beside
them: a seeded ``/pack`` equals ``cli.pack`` with the same seed and weights
bit for bit (with and without the proximal refinement); ``/ddg`` with the
shipped converted checkpoints gives the JAX package's shipped prediction for
2FTL KI15G within 1e-4 kcal/mol; every response carries the keys (and the
value types) of the JAX server's answer to the same request; the lock
serializes the device work of concurrent requests, each of which still
gives its lone answer.
"""
from __future__ import annotations

import http.client
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from conftest import FIXTURES
from torch_threads import _threads  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
CKPTS = REPO / "docs" / "ckpts" / "affinity_skempi_mini_pretrained"
PDB_2FTL = Path(FIXTURES) / "2ftl.pdb"


def _serve_args(tmp_path, n_steps=2, **kw):
    return SimpleNamespace(**{**dict(
        host="127.0.0.1", port=0, ckpt=None, affinity_ckpt=None, pre_ckpt=None,
        n_steps=n_steps, precision="float32", no_fused=False, geometry="global",
        device="cpu", seed=0, molprobity_loc=None, warmup=None, max_body_mb=1,
        tmp_dir=str(tmp_path / "serve_tmp")), **kw})


def _start(args):
    from packppi_torch.cli.serve import make_server

    srv = make_server(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    srv = _start(_serve_args(tmp_path_factory.mktemp("serve")))
    yield srv.server_address
    srv.shutdown()


def _request(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=600)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    conn.close()
    return resp.status, payload


def _chain_i() -> str:
    """2FTL's inhibitor chain alone (58 residues): a short structure."""
    lines = PDB_2FTL.read_text().splitlines()
    return "\n".join(ln for ln in lines if ln.startswith("ATOM") and ln[21] == "I") + "\nEND\n"


# -- the eight tests of tests/test_serve.py ---------------------------------

def test_healthz(server):
    status, out = _request(server, "GET", "/healthz")
    assert status == 200
    assert out["status"] == "ok" and out["backend"] == "cpu" and out["devices"] == 1
    assert out["random_weights"] is True
    assert "/pack" in out["endpoints"]


def test_pack_roundtrip(server):
    from packppi_torch.structure import from_pdb_string

    pdb_text = PDB_2FTL.read_text()
    status, out = _request(server, "POST", "/pack", json.dumps({"pdb": pdb_text, "seed": 7}))
    assert status == 200, out
    prot_in = from_pdb_string(pdb_text, mse_to_met=True)
    prot_out = from_pdb_string(out["pdb"])
    assert len(prot_out.aaindex) == len(prot_in.aaindex)
    m = out["metrics"]
    assert m["device_seconds"] > 0
    assert m["random_weights"] is True
    assert "chi_1_acc" in m and "atom_rmsd" in m
    assert type(m["clashscore_is_exact"]) is float and m["clashscore_is_exact"] == 0.0
    _, health = _request(server, "GET", "/healthz")
    assert m["length_bucket"] in health["buckets_warm"]


def test_pack_is_seed_deterministic(server):
    body = json.dumps({"pdb": PDB_2FTL.read_text(), "seed": 11, "metrics": False})
    _, a = _request(server, "POST", "/pack", body)
    _, b = _request(server, "POST", "/pack", body)
    assert a["pdb"] == b["pdb"]


def test_pack_raw_pdb_body(server):
    status, out = _request(server, "POST", "/pack", PDB_2FTL.read_text(),
                           {"Content-Type": "text/plain"})
    assert status == 200, out
    assert out["pdb"].startswith(("ATOM", "MODEL"))


def test_prox_endpoint(server):
    body = json.dumps({"pdb": PDB_2FTL.read_text(), "num_steps": 3, "metrics": False})
    status, out = _request(server, "POST", "/prox", body)
    assert status == 200, out
    m = out["metrics"]
    assert {"accepted", "objective_initial", "objective_final"} <= set(m)
    assert m["accepted"] == (m["objective_final"] < m["objective_initial"])
    assert out["pdb"]


def test_ddg_endpoint(server):
    body = json.dumps({"pdb": PDB_2FTL.read_text(), "mutstr": "KI15G"})
    status, out = _request(server, "POST", "/ddg", body)
    assert status == 200, out
    assert np.isfinite(out["ddg_pred"])
    assert out["random_weights"] is True


def test_error_handling(server):
    status, out = _request(server, "POST", "/pack", json.dumps({"nope": 1}))
    assert status == 400 and "error" in out
    status, out = _request(server, "POST", "/ddg", json.dumps({"pdb": "ATOM", "mutstr": ""}))
    assert status == 400
    status, out = _request(server, "POST", "/unknown", json.dumps({"pdb": "x"}))
    assert status == 404
    status, out = _request(server, "POST", "/pack", json.dumps({"pdb": "not a pdb at all"}))
    assert status in (400, 500) and "error" in out
    status, _ = _request(server, "GET", "/healthz")
    assert status == 200


def test_request_validation(server):
    pdb_text = PDB_2FTL.read_text()
    status, out = _request(server, "POST", "/pack", json.dumps(
        {"pdb": pdb_text, "n_samples": 100000000}))
    assert status == 400 and "n_samples" in out["error"]
    status, out = _request(server, "POST", "/prox", json.dumps(
        {"pdb": pdb_text, "num_steps": "fast"}))
    assert status == 400 and "num_steps" in out["error"]
    status, out = _request(server, "POST", "/prox", json.dumps({"pdb": pdb_text, "num_steps": 0}))
    assert status == 400
    status, out = _request(server, "POST", "/pack", "x" * (1024 * 1024 + 1))
    assert status == 413 and "max_body_mb" in out["error"]


# -- beyond the JAX package's tests -------------------------------------------

@pytest.mark.parametrize("proximal", [False, True], ids=["pack", "pack_proximal"])
def test_seeded_pack_equals_cli_pack(server, tmp_path, proximal):
    """The server's weights are those of ``cli.pack --seed 0`` without a
    checkpoint; a request with seed 0 then writes the same PDB."""
    from packppi_torch.cli.pack import build_parser, run

    pdb = tmp_path / "chain_i.pdb"
    pdb.write_text(_chain_i())
    body = {"pdb": pdb.read_text(), "seed": 0, "metrics": False, "use_proximal": proximal}
    status, out = _request(server, "POST", "/pack", json.dumps(body))
    assert status == 200, out
    run(build_parser().parse_args(
        ["--input", str(pdb), "--outdir", str(tmp_path), "--device", "cpu", "--seed", "0",
         "--n_steps", "2", "--precision", "float32"] + (["--use_proximal"] if proximal else [])))
    assert out["pdb"] == (tmp_path / "structure.pdb").read_text()


def test_ddg_with_shipped_checkpoints_matches_jax(tmp_path):
    with open(CKPTS / "ddg_eval.jsonl") as f:
        want = next(r["ddg_pred"] for r in map(json.loads, f)
                    if (r["complex"], r["mutstr"]) == ("2FTL_E_I", "KI15G"))
    srv = _start(_serve_args(tmp_path, affinity_ckpt=str(CKPTS / "torch_affinity.pt"),
                             pre_ckpt=str(CKPTS / "torch_backbone.pt")))
    try:
        status, out = _request(srv.server_address, "POST", "/ddg", json.dumps(
            {"pdb": PDB_2FTL.read_text(), "mutstr": "KI15G"}))
    finally:
        srv.shutdown()
    assert status == 200, out
    assert out["random_weights"] is False
    assert out["ddg_pred"] == pytest.approx(want, abs=1e-4)


def _shape(payload):
    """A response's keys and value types, nested one level."""
    kind = lambda v: "number" if isinstance(v, float) else type(v).__name__
    return {k: ({kk: kind(vv) for kk, vv in v.items()} if isinstance(v, dict) else kind(v))
            for k, v in payload.items()}


def test_responses_have_the_jax_servers_keys(server, tmp_path):
    """The same requests to both servers: the same keys and value types in
    every answer (the JAX server unfused on the CPU, one step)."""
    from packppi_tpu.cli.serve import make_server as jax_make_server

    jax_args = _serve_args(tmp_path, n_steps=1, no_fused=True, platform=None)
    jax_srv = jax_make_server(jax_args)
    threading.Thread(target=jax_srv.serve_forever, daemon=True).start()
    short = _chain_i()
    requests = [("GET", "/healthz", None),
                ("POST", "/pack", {"pdb": short, "seed": 1, "use_proximal": True}),
                # the refinement's length, so the JAX server compiles it once
                ("POST", "/prox", {"pdb": short, "num_steps": 50}),
                ("POST", "/ddg", {"pdb": PDB_2FTL.read_text(), "mutstr": "KI15G"})]
    try:
        for method, path, body in requests:
            body = None if body is None else json.dumps(body)
            (s1, ours), (s2, theirs) = (_request(addr, method, path, body)
                                        for addr in (server, jax_srv.server_address))
            assert s1 == s2 == 200, (path, ours, theirs)
            assert _shape(ours) == _shape(theirs), path
    finally:
        jax_srv.shutdown()


def test_concurrent_requests_serialize_on_the_device_lock(tmp_path):
    """Two seeded requests at once: their samplings never overlap (the
    lock lets one request at a time on the device) and each gives its lone
    answer."""
    import time

    from packppi_torch.cli.serve import make_server

    sessions = {}
    srv = make_server(_serve_args(tmp_path), sessions)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    model = sessions["pack"].model
    sample, active, overlaps = model.sample, [0], []

    def watched(*a, **k):
        active[0] += 1
        overlaps.append(active[0] > 1)
        time.sleep(0.2)                     # widen the window a second request could use
        try:
            return sample(*a, **k)
        finally:
            active[0] -= 1

    try:
        short = _chain_i()
        bodies = [json.dumps({"pdb": short, "seed": s, "metrics": False}) for s in (3, 4)]
        alone = [_request(srv.server_address, "POST", "/pack", b)[1]["pdb"] for b in bodies]
        model.sample = watched
        with ThreadPoolExecutor(2) as pool:
            both = list(pool.map(lambda b: _request(srv.server_address, "POST", "/pack", b),
                                 bodies))
    finally:
        srv.shutdown()
    assert [s for s, _ in both] == [200, 200]
    assert [p["pdb"] for _, p in both] == alone
    assert overlaps == [False, False]

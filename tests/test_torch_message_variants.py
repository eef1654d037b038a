"""The port's message routes of kernel rows 4 (``message_geom``), 5
(``message_gather``) and 1b (``message_chain``, the edge pass with the chain
folded in), as their wrappers run them on CPU tensors (the plain versions),
against the JAX package's Pallas kernels fed by the JAX
``FactoredMessageMLP``'s own operand preparation (``geom_fused``,
``geom_fused_gather``, ``geom_fused_lanes(chain_weights=...)``).

float32: the jitted entry points in interpret mode, within 2e-5 (rows 4 and
5, the JAX package's kernel-vs-unfused bound) and 3e-5 (row 1b, its
fused-chain bound).

bf16: XLA:CPU cannot compile the interpreted lane-major kernels' bf16
products, and a jitted call drops bf16 round trips, so the entry points are
replaced by their kernel bodies run eagerly on one block of all L nodes
(``eager_entries``). The bodies' second message product takes the float32
hidden activation (``_message_chain``), which XLA:CPU multiplies exactly
while the unfused flax path and the port round it to bf16; the bodies run
with ``_message_chain`` rounding that activation to the compute dtype, and
are otherwise unchanged. Limits relative to max|ref|: max |d| <= 2^-6 and
mean |d| <= 2^-16; a control (the port's version without its rounding
points) must read more than 4x the mean limit.
"""
import contextlib
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import packppi_tpu.ops.pallas_ipmp as pallas_ipmp
from packppi_tpu.geometry.rigid import Rigid as JaxRigid
from packppi_tpu.models.ipmp import FactoredMessageMLP as JaxMessageMLP
from packppi_torch.data import stack_batch
from packppi_torch.geometry import bb_frames_from_atom14
from packppi_torch.models.ipmp import FactoredMessageMLP, MessagePassingStack
from packppi_torch.ops.graph import masked_knn
from packppi_torch.ops.message import (message_chain, message_chain_plain, message_gather,
                                       message_geom, message_geom_plain, message_plain)
from packppi_torch.structure import featurize, from_pdb_file

from conftest import FIXTURES
from torch_threads import _threads  # noqa: F401 (autouse fixture)

H, P, K, L = 128, 8, 16, 40
BF16_MAX_REL, BF16_MEAN_REL = 2.0 ** -6, 2.0 ** -16


class _Out:
    """A kernel body's output ref: takes whole and sliced writes."""

    def __init__(self, shape, dtype):
        self.dtype = dtype
        self.value = jnp.zeros(shape, dtype)

    def __setitem__(self, key, value):
        self.value = self.value.at[key].set(value.astype(self.dtype))


def _row(a):
    return jnp.asarray(a, jnp.float32).reshape(1, -1)


def eager_geom(per_i, pjg, h_E, pl, ng, rot9, trans3, mask, w_he, w_g_perm, b_e, w1, b1, w2,
               b2, K=32, P=8, act_name="relu", pool=True, blk=64, compute_dtype=jnp.bfloat16,
               interpret=False):
    """``fused_message_geom`` with ``_geom_fused_kernel`` run eagerly on one
    block of all L nodes."""
    n, h = per_i.shape
    f32 = jnp.float32
    out = _Out((n, h) if pool else (n * K, h), f32 if pool else h_E.dtype)
    pallas_ipmp._geom_fused_kernel(
        per_i.astype(f32), pjg.reshape(n * K, h), h_E.reshape(n * K, -1), pl.astype(f32),
        ng.reshape(n * K, -1).astype(f32), rot9.astype(f32), trans3.astype(f32),
        mask.astype(f32), w_he.astype(f32), w_g_perm.astype(f32), _row(b_e), w1.astype(f32),
        _row(b1), w2.astype(f32), _row(b2), out, K=K, P=P, act_name=act_name, pool=pool,
        compute_dtype=compute_dtype)
    return out.value if pool else out.value.reshape(n, K, h)


def eager_geom_gather(per_i, h_E, stackT, idx_flat, per_j, pg, mask, w_he, w_g_perm, b_e, w1,
                      b1, w2, b2, K=32, P=8, act_name="relu", pool=True, blk=64,
                      compute_dtype=jnp.bfloat16, interpret=False):
    """``fused_message_geom_gather`` with ``_geom_gather_kernel`` run eagerly
    on one block of all L nodes."""
    n, h = per_i.shape
    f32 = jnp.float32
    out = _Out((n, h) if pool else (n * K, h), f32 if pool else h_E.dtype)
    pallas_ipmp._geom_gather_kernel(
        per_i.astype(f32), h_E.reshape(n * K, -1), stackT.astype(f32),
        idx_flat.astype(jnp.int32), per_j, pg.astype(f32), mask.astype(f32), w_he.astype(f32),
        w_g_perm.astype(f32).T, _row(b_e), w1.astype(f32), _row(b1), w2.astype(f32), _row(b2),
        out, K=K, P=P, L=n, act_name=act_name, pool=pool, compute_dtype=compute_dtype)
    return out.value if pool else out.value.reshape(n, K, h)


def eager_geom_lanes(per_i, pjg, h_E, stackT, ngT, mask, w_he, w_g_perm, b_e, w1, b1, w2, b2,
                     chain_weights=None, K=32, P=8, act_name="relu", pool=True, blk=128,
                     compute_dtype=jnp.bfloat16, interpret=False):
    """``fused_message_geom_lanes`` with ``_geom_lanes_kernel`` (and its
    chain, when given) run eagerly on one block of all L nodes."""
    n, h = per_i.shape
    f32 = jnp.float32
    with_chain = chain_weights is not None and not pool
    extra = ()
    if with_chain:
        ln2s, ln2b, cf1, cf1b, cf2, cf2b, ln3s, ln3b = chain_weights
        extra = (_row(ln2s), _row(ln2b), cf1.astype(f32), _row(cf1b), cf2.astype(f32),
                 _row(cf2b), _row(ln3s), _row(ln3b))
    out = _Out((n, h) if pool else (n * K, h), f32 if pool else h_E.dtype)
    pallas_ipmp._geom_lanes_kernel(
        per_i.astype(f32), pjg.reshape(n * K, h), h_E.reshape(n * K, -1), stackT.astype(f32),
        ngT.reshape(n * K, -1).astype(f32), mask.astype(f32), w_he.astype(f32),
        w_g_perm.astype(f32).T, _row(b_e), w1.astype(f32), _row(b1), w2.astype(f32), _row(b2),
        *extra, out, K=K, P=P, act_name=act_name, pool=pool, compute_dtype=compute_dtype,
        with_chain=with_chain)
    return out.value if pool else out.value.reshape(n, K, h)


def _rounded_message_chain(x, w1, b1, w2, b2, act):
    """``pallas_ipmp._message_chain`` with its hidden activation rounded to
    the compute dtype (the weights' dtype) before the second product."""
    x = act(jnp.dot(x, w1, preferred_element_type=jnp.float32) + b1)
    return jnp.dot(x.astype(w2.dtype), w2, preferred_element_type=jnp.float32) + b2


@contextlib.contextmanager
def eager_entries(round_hidden: bool):
    """The three in-kernel-geometry entry points of ``pallas_ipmp`` replaced
    by their kernel bodies run eagerly (``round_hidden``: with the rounded
    ``_message_chain``). The JAX ``FactoredMessageMLP`` imports the entry
    points at call time, so its methods pick the replacements up."""
    with contextlib.ExitStack() as stack:
        for name, fn in (("fused_message_geom", eager_geom),
                         ("fused_message_geom_gather", eager_geom_gather),
                         ("fused_message_geom_lanes", eager_geom_lanes)):
            stack.enter_context(mock.patch.object(pallas_ipmp, name, fn))
        if round_hidden:
            stack.enter_context(mock.patch.object(pallas_ipmp, "_message_chain",
                                                  _rounded_message_chain))
        yield


@pytest.fixture(scope="module")
def case():
    """Real backbone frames and kNN graph of 40 residues of 1BRS; node and
    edge states, points, message and chain weights drawn by numpy from a
    seed."""
    feats = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), chain_id="A"))
    feats = {k: v[:L] for k, v in feats.items()}
    batch = stack_batch([feats], "cpu", target_len=L)
    _, idx = masked_knn(batch.X[:, :, 1], batch.residue_mask, K)
    mask = MessagePassingStack.attend_mask(batch.residue_mask, idx)
    mask[0, 3, 5:] = 0.0                       # a few masked edges
    frames = bb_frames_from_atom14(batch.X)

    rng = np.random.default_rng(5)
    f32 = np.float32
    xavier = lambda i, o: (rng.uniform(-1, 1, (i, o)) * np.sqrt(6 / (i + o))).astype(f32)
    normal = lambda *s, sd=0.1: rng.normal(0, sd, s).astype(f32)
    params = {
        "Dense_i": {"kernel": xavier(H, H)},
        "Dense_j": {"kernel": xavier(H, H)},
        "Dense_e": {"kernel": xavier(H + 9 * P, H), "bias": normal(H)},
        "Dense_1": {"kernel": xavier(H, H), "bias": normal(H)},
        "Dense_2": {"kernel": xavier(H, H), "bias": normal(H)},
    }
    chain = (1 + normal(H), normal(H), xavier(H, 4 * H), normal(4 * H), xavier(4 * H, H),
             normal(H), 1 + normal(H), normal(H))
    return dict(
        idx=idx, mask=mask, frames=frames, params=params, chain=chain,
        h_V=rng.normal(size=(1, L, H)).astype(f32),
        h_E=rng.normal(size=(1, L, K, H)).astype(f32),
        p_local=(3 * rng.normal(size=(1, L, P, 3))).astype(f32))


def port_mlp(params, act="relu"):
    """The port's FactoredMessageMLP on the JAX MLP's parameters."""
    mlp = FactoredMessageMLP(H, H, 9 * P, act)
    p = params
    w_in = np.concatenate([p["Dense_i"]["kernel"], p["Dense_e"]["kernel"][:H],
                           p["Dense_j"]["kernel"], p["Dense_e"]["kernel"][H:]], 0)
    sd = {"W_in.weight": w_in.T, "W_in.bias": p["Dense_e"]["bias"],
          "W_inter.0.weight": p["Dense_1"]["kernel"].T, "W_inter.0.bias": p["Dense_1"]["bias"],
          "W_out.weight": p["Dense_2"]["kernel"].T, "W_out.bias": p["Dense_2"]["bias"]}
    mlp.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return mlp


def port_chain_weights(chain):
    """The JAX chain weights (kernels [in, out]) in the port's Linear layout."""
    ln_a_s, ln_a_b, f1, f1b, f2, f2b, ln_b_s, ln_b_b = chain
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (ln_a_s, ln_a_b, f1.T, f1b, f2.T, f2b, ln_b_s, ln_b_b))


def _inputs(case, tdt):
    """The port's message arguments (h_V, h_E, idx, p_local, frames, mask)."""
    return (torch.from_numpy(case["h_V"]).to(tdt), torch.from_numpy(case["h_E"]).to(tdt),
            case["idx"], torch.from_numpy(case["p_local"]), case["frames"], case["mask"])


def _port(case, route, tdt, pool, act="relu"):
    """The port's route on CPU tensors (its wrapper; the plain version runs)."""
    mlp = port_mlp(case["params"], act)
    args = _inputs(case, tdt)
    with torch.no_grad():
        if route == "fold":
            return message_chain(*mlp.operands(*args), *port_chain_weights(case["chain"]), act)
        return mlp(*args, pool=pool, fused=route)


def _jax(case, route, dtype, pool, act="relu"):
    """The JAX FactoredMessageMLP's method for the route; float32 through
    the jitted entry in interpret mode, bf16 through ``eager_entries``."""
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    mlp = JaxMessageMLP(H, H, 9 * P, act=act, dtype=jdt)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, case["params"])}
    fr = case["frames"]
    frames = JaxRigid(jnp.asarray(fr.rot.numpy()), jnp.asarray(fr.trans.numpy()))
    sdt = jdt or jnp.float32
    args = (jnp.asarray(case["h_V"], sdt), jnp.asarray(case["h_E"], sdt),
            jnp.asarray(case["idx"].numpy()), jnp.asarray(case["p_local"]), frames,
            jnp.asarray(case["mask"].numpy()))
    method = {"geom": JaxMessageMLP.geom_fused, "geom_gather": JaxMessageMLP.geom_fused_gather,
              "fold": JaxMessageMLP.geom_fused_lanes}[route]
    kw = dict(pool=pool, interpret=True)
    if route == "fold":
        kw["chain_weights"] = tuple(jnp.asarray(a) for a in case["chain"])
    ctx = eager_entries(round_hidden=True) if dtype == "bfloat16" else contextlib.nullcontext()
    with ctx:
        out = mlp.apply(variables, *args, method=method, **kw)
    return np.asarray(out.astype(jnp.float32))


def _readings(got, ref):
    """(max |d|, mean |d|) relative to max|ref|."""
    d = np.abs(got - ref)
    scale = np.abs(ref).max()
    return d.max() / scale, d.mean() / scale


ROUTES = [("geom", True), ("geom", False), ("geom_gather", True), ("geom_gather", False),
          ("fold", False)]
IDS = ["geom-pool", "geom-edge", "gather-pool", "gather-edge", "fold"]


@pytest.mark.parametrize("route,pool", ROUTES, ids=IDS)
def test_route_f32_matches_pallas_kernel(case, route, pool):
    ours = _port(case, route, torch.float32, pool)
    ref = _jax(case, route, "float32", pool)
    assert ours.dtype == torch.float32
    assert ours.shape == ((1, L, H) if pool else (1, L, K, H))
    np.testing.assert_allclose(ours.numpy(), ref, atol=3e-5 if route == "fold" else 2e-5,
                               rtol=0)


@pytest.mark.parametrize("route,pool", ROUTES, ids=IDS)
def test_route_bf16_matches_pallas_kernel_body(case, route, pool):
    ours = _port(case, route, torch.bfloat16, pool)
    assert ours.dtype == (torch.float32 if pool else torch.bfloat16)
    dmax, dmean = _readings(ours.float().numpy(), _jax(case, route, "bfloat16", pool))
    assert dmax <= BF16_MAX_REL and dmean <= BF16_MEAN_REL, (dmax, dmean)


@pytest.mark.parametrize("route,pool", ROUTES, ids=IDS)
def test_route_bf16_tolerance_rejects_unrounded(case, route, pool):
    """The control: the port's route with no bf16 rounding point (run in
    float32 on the bf16-rounded inputs; an edge output written in bf16)."""
    case32 = dict(case, h_V=torch.from_numpy(case["h_V"]).bfloat16().float().numpy(),
                  h_E=torch.from_numpy(case["h_E"]).bfloat16().float().numpy())
    control = _port(case32, route, torch.float32, pool)
    control = control if pool else control.bfloat16()
    _, dmean = _readings(control.float().numpy(), _jax(case, route, "bfloat16", pool))
    assert dmean > 4 * BF16_MEAN_REL, dmean


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("route,pool", ROUTES, ids=IDS)
def test_route_gelu_matches_pallas_kernel(case, route, pool, dtype):
    """Rows 4, 5 and 1b with ``act="gelu"`` (the JAX kernels' ``act_name``),
    at the limits of the relu tests above."""
    ours = _port(case, route, {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype],
                 pool, "gelu")
    ref = _jax(case, route, dtype, pool, "gelu")
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, atol=3e-5 if route == "fold" else 2e-5,
                                   rtol=0)
    else:
        dmax, dmean = _readings(ours.float().numpy(), ref)
        assert dmax <= BF16_MAX_REL and dmean <= BF16_MEAN_REL, (dmax, dmean)
    assert np.abs(ref - _jax(case, route, dtype, pool)).max() > 1e-2   # gelu is not relu


def test_fold_equals_message_then_chain(case):
    """Row 1b's plain version is ``message_plain`` then ``chain_plain``; the
    network's two-kernel edge pass gives the same, value for value."""
    from packppi_torch.ops.chain import chain_plain

    mlp = port_mlp(case["params"])
    ops = mlp.operands(*_inputs(case, torch.bfloat16))
    cw = port_chain_weights(case["chain"])
    with torch.no_grad():
        folded = message_chain(*ops, *cw)
        msg = message_plain(*ops, False)
        two = chain_plain(ops[2].reshape(-1, H), msg.reshape(-1, H),
                          case["mask"].reshape(-1).float(), *cw, True)
    torch.testing.assert_close(folded.reshape(-1, H), two, rtol=0, atol=0)


def test_wrappers_take_plain_versions_on_cpu(case):
    mlp = port_mlp(case["params"])
    args = _inputs(case, torch.float32)
    cw = port_chain_weights(case["chain"])
    counts = lambda: (message_geom.launches, message_gather.launches, message_chain.launches)
    before = counts()
    with torch.no_grad():
        ops = mlp.geom_operands(*args)
        torch.testing.assert_close(message_geom(*ops, True), message_geom_plain(*ops, True),
                                   rtol=0, atol=0)
        ops = mlp.operands(*args)
        torch.testing.assert_close(message_gather(*ops, False), message_plain(*ops, False),
                                   rtol=0, atol=0)
        torch.testing.assert_close(message_chain(*ops, *cw), message_chain_plain(*ops, *cw),
                                   rtol=0, atol=0)
    assert counts() == before              # only kernel launches count

"""The port's message, chain and whole-layer passes at network widths other
than 128 / 128 / 8 / 32, on the CPU (the plain versions that the wrappers
run for CPU tensors), against the JAX package's Pallas kernels, which read
their widths from their operands, in interpret mode, at (H, He, P, K) =
(64, 64, 4, 16), (128, 64, 16, 48) and (32, 96, 3, 96): hidden_dim,
edge_features, n_points and top_k each away from the default, He != H in
two, K past the kernels' 64-row tile in one. The edge passes that add the
message to h_E (the folded edge pass, the whole layer's edge pass, the edge
chain) need He = H and run at (H, H, P, K). The JAX folded edge pass
(row 1b) reshapes its 1,024-row chain chunks by K, which K = 48 and 96 do
not divide: its test takes K = 32 and 64 at those two widths.

Inputs: 1BRS's chain A (L = 100), its kNN graph, node and edge states,
points and weights drawn by numpy from a seed.

Tolerances, each the limit the default-width tests hold the same pass to:
* float32 against the jitted entry in interpret mode: 2e-5 for the message
  routes (rows 1, 3, 4, 5) and 3e-5 for the passes that end in the residual
  chain (rows 1b, 2, 6), the JAX package's kernel-vs-unfused bounds;
* gradients of the feature-message pass (row 3) against ``jax.grad``
  through ``fused_message_diff``: every operand within 5e-4 of its max;
* bf16, row 1 against its kernel body run eagerly on one block of all L
  nodes (``test_torch_message_variants.eager_entries``): max |d| <= 2^-6
  and mean |d| <= 2^-16 of max|ref|;
* the whole score network on weights carried across by
  ``weights.from_flax_params``: 1e-4 in float32, 6e-2 in bf16 (the JAX
  package's bf16 fused-vs-unfused chain bound), as ``test_torch_network.py``;
* two steps of the ODE sampler from the same initial chis: 5e-4 rad, the
  bound of the reference trajectory replay.
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.data import stack_batch as jax_stack_batch
from packppi_tpu.geometry.rigid import Rigid as JaxRigid
from packppi_tpu.models import ChiScoreNetwork as JaxChiScoreNetwork
from packppi_tpu.models import NetworkConfig as JaxNetworkConfig
from packppi_tpu.models import SampleConfig as JaxSampleConfig
from packppi_tpu.models import TorsionalDiffusion as JaxTorsionalDiffusion
from packppi_tpu.models.ipmp import FactoredMessageMLP as JaxMessageMLP
from packppi_tpu.ops.pallas_ipmp import fused_message, fused_message_diff
from packppi_tpu.ops.pallas_layer import _fused_pass, fused_chain
from packppi_torch.data import stack_batch
from packppi_torch.geometry import bb_frames_from_atom14
from packppi_torch.models import ChiScoreNetwork, NetworkConfig, TorsionalDiffusion
from packppi_torch.models.ipmp import FactoredMessageMLP, MessagePassingStack
from packppi_torch.ops.chain import chain
from packppi_torch.ops.graph import masked_knn
from packppi_torch.ops.layer import layer_edge, layer_node
from packppi_torch.ops.message import message_chain
from packppi_torch.ops.message_feat import message_feat, message_feat_plain
from packppi_torch.structure import featurize, from_pdb_file
from packppi_torch.weights import from_flax_params

from conftest import FIXTURES
from test_torch_message_variants import eager_entries
from torch_threads import _threads  # noqa: F401 (autouse fixture)

L = 100
WIDTHS = [(64, 64, 4, 16), (128, 64, 16, 48), (32, 96, 3, 96)]
IDS = ["H64-He64-P4-K16", "H128-He64-P16-K48", "H32-He96-P3-K96"]
F32_MSG, F32_CHAIN, GRAD_REL = 2e-5, 3e-5, 5e-4
BF16_MAX_REL, BF16_MEAN_REL = 2.0 ** -6, 2.0 ** -16


@pytest.fixture(scope="module")
def graph():
    """1BRS chain A's first L residues: frames, kNN graphs by K, the batch."""
    feats = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), chain_id="A"))
    feats = {k: v[:L] for k, v in feats.items()}
    batch = stack_batch([feats], "cpu", target_len=L)
    return dict(batch=batch, frames=bb_frames_from_atom14(batch.X))


_CASES: dict = {}


def make_case(graph, H, He, P, K):
    """Node and edge states, points, message and chain weights at (H, He, P,
    K), drawn by numpy from a seed, on ``graph``'s kNN graph of K."""
    key = (H, He, P, K)
    if key in _CASES:
        return _CASES[key]
    batch = graph["batch"]
    _, idx = masked_knn(batch.X[:, :, 1], batch.residue_mask, K)
    mask = MessagePassingStack.attend_mask(batch.residue_mask, idx)
    mask[0, 3, 5:] = 0.0                       # a few masked edges
    rng = np.random.default_rng(H + He + P + K)
    f32 = np.float32
    xavier = lambda i, o: (rng.uniform(-1, 1, (i, o)) * np.sqrt(6 / (i + o))).astype(f32)
    normal = lambda *s, sd=0.1: rng.normal(0, sd, s).astype(f32)
    params = {"Dense_i": {"kernel": xavier(H, H)}, "Dense_j": {"kernel": xavier(H, H)},
              "Dense_e": {"kernel": xavier(He + 9 * P, H), "bias": normal(H)},
              "Dense_1": {"kernel": xavier(H, H), "bias": normal(H)},
              "Dense_2": {"kernel": xavier(H, H), "bias": normal(H)}}
    chain_w = (1 + normal(H), normal(H), xavier(H, 4 * H), normal(4 * H), xavier(4 * H, H),
               normal(H), 1 + normal(H), normal(H))
    _CASES[key] = dict(
        H=H, He=He, P=P, K=K, idx=idx, mask=mask, frames=graph["frames"], params=params,
        chain=chain_w, h_V=rng.normal(size=(1, L, H)).astype(f32),
        h_E=rng.normal(size=(1, L, K, He)).astype(f32),
        p_local=(3 * rng.normal(size=(1, L, P, 3))).astype(f32))
    return _CASES[key]


def port_mlp(c):
    """The port's FactoredMessageMLP on the JAX MLP's parameters."""
    H, He, P, p = c["H"], c["He"], c["P"], c["params"]
    mlp = FactoredMessageMLP(H, He, 9 * P)
    w_e = p["Dense_e"]["kernel"]
    w_in = np.concatenate([p["Dense_i"]["kernel"], w_e[:He], p["Dense_j"]["kernel"], w_e[He:]], 0)
    sd = {"W_in.weight": w_in.T, "W_in.bias": p["Dense_e"]["bias"],
          "W_inter.0.weight": p["Dense_1"]["kernel"].T, "W_inter.0.bias": p["Dense_1"]["bias"],
          "W_out.weight": p["Dense_2"]["kernel"].T, "W_out.bias": p["Dense_2"]["bias"]}
    mlp.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return mlp


def port_chain_weights(c):
    """The JAX chain weights (kernels [in, out]) in the port's Linear layout."""
    ln_a_s, ln_a_b, f1, f1b, f2, f2b, ln_b_s, ln_b_b = c["chain"]
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (ln_a_s, ln_a_b, f1.T, f1b, f2.T, f2b, ln_b_s, ln_b_b))


def _inputs(c, tdt):
    return (torch.from_numpy(c["h_V"]).to(tdt), torch.from_numpy(c["h_E"]).to(tdt), c["idx"],
            torch.from_numpy(c["p_local"]), c["frames"], c["mask"])


def _port(c, route, tdt, pool):
    mlp = port_mlp(c)
    with torch.no_grad():
        if route == "fold":
            return message_chain(*mlp.operands(*_inputs(c, tdt)), *port_chain_weights(c))
        return mlp(*_inputs(c, tdt), pool=pool, fused=route)


def _jax(c, route, dtype, pool):
    """The JAX FactoredMessageMLP's route: float32 through the jitted entry
    in interpret mode, bf16 through the kernel bodies run eagerly."""
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    mlp = JaxMessageMLP(c["H"], c["He"], 9 * c["P"], dtype=jdt)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, c["params"])}
    fr = c["frames"]
    sdt = jdt or jnp.float32
    args = (jnp.asarray(c["h_V"], sdt), jnp.asarray(c["h_E"], sdt),
            jnp.asarray(c["idx"].numpy()), jnp.asarray(c["p_local"]),
            JaxRigid(jnp.asarray(fr.rot.numpy()), jnp.asarray(fr.trans.numpy())),
            jnp.asarray(c["mask"].numpy()))
    method = {"geom_lanes": JaxMessageMLP.geom_fused_lanes, "geom": JaxMessageMLP.geom_fused,
              "geom_gather": JaxMessageMLP.geom_fused_gather,
              "fold": JaxMessageMLP.geom_fused_lanes}[route]
    kw = dict(pool=pool, interpret=True)
    if route == "fold":
        kw["chain_weights"] = tuple(jnp.asarray(a) for a in c["chain"])
    ctx = eager_entries(round_hidden=True) if dtype == "bfloat16" else contextlib.nullcontext()
    with ctx:
        out = mlp.apply(variables, *args, method=method, **kw)
    return np.asarray(out.astype(jnp.float32))


def _square(graph, H, He, P, K):
    """The case at He = H, for the passes that add the message to h_E."""
    return make_case(graph, H, H, P, K)


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
@pytest.mark.parametrize("route", ["geom_lanes", "geom", "geom_gather"],
                         ids=["row1-lanes", "row4-geom", "row5-gather"])
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_message_route_f32_matches_pallas_kernel(graph, widths, route, pool):
    c = make_case(graph, *widths)
    H, K = c["H"], c["K"]
    ours = _port(c, route, torch.float32, pool)
    assert ours.shape == ((1, L, H) if pool else (1, L, K, H))
    np.testing.assert_allclose(ours.numpy(), _jax(c, route, "float32", pool), atol=F32_MSG,
                               rtol=0)


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_message_route_bf16_matches_pallas_kernel_body(graph, widths, pool):
    """Row 1 in bf16 against ``_geom_lanes_kernel`` run eagerly (the
    second product's hidden activation rounded, as the port rounds it)."""
    c = make_case(graph, *widths)
    ours = _port(c, "geom_lanes", torch.bfloat16, pool).float().numpy()
    ref = _jax(c, "geom_lanes", "bfloat16", pool)
    d, scale = np.abs(ours - ref), np.abs(ref).max()
    assert d.max() <= BF16_MAX_REL * scale and d.mean() <= BF16_MEAN_REL * scale, \
        (d.max() / scale, d.mean() / scale)


@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_fold_f32_matches_pallas_kernel(graph, widths):
    """Row 1b: the edge pass with the chain folded in, at He = H (and at a K
    that divides 1,024, where the JAX kernel runs)."""
    H, _, P, K = widths
    c = _square(graph, H, H, P, {48: 32, 96: 64}.get(K, K))
    ours = _port(c, "fold", torch.float32, False)
    assert ours.shape == (1, L, c["K"], c["H"])
    np.testing.assert_allclose(ours.numpy(), _jax(c, "fold", "float32", False), atol=F32_CHAIN,
                               rtol=0)


def _chain_case(c, edge):
    """(port operands of ``ops.chain.chain``, JAX ``fused_chain`` arguments):
    the node chain on h_V and a message, the edge chain on h_E (He = H) and
    an edge message, with the case's chain weights."""
    H, K = c["H"], c["K"]
    rng = np.random.default_rng(7)
    rows = L * K if edge else L
    x = c["h_E"].reshape(rows, H) if edge else c["h_V"].reshape(rows, H)
    msg = rng.normal(size=(rows, H)).astype(np.float32)
    mask = (c["mask"].numpy().reshape(-1) if edge else np.ones(L, np.float32)).copy()
    mask[-3:] = 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ours = (t(x), t(msg), t(mask), *port_chain_weights(c))
    j = jnp.asarray
    theirs = (j(x), j(msg), j(mask)[:, None], *(j(a) for a in c["chain"]))
    return ours, theirs


@pytest.mark.parametrize("edge", [False, True], ids=["node", "edge"])
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_chain_f32_matches_pallas_kernel(graph, widths, edge):
    """Row 2 at width H (F = 4H)."""
    c = _square(graph, *widths)
    ours, theirs = _chain_case(c, edge)
    got = chain(*ours, pre_mask=edge)
    run = jax.jit(lambda *a: fused_chain(*a, act_name="relu", compute_dtype=jnp.float32,
                                         pre_mask=edge, interpret=True))
    want = run.lower(*theirs).compile(
        compiler_options={"xla_allow_excess_precision": False})(*theirs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_CHAIN, rtol=0)


def _feat_operands(c):
    """(port operands of ``message_feat``, JAX ``fused_message`` operands of
    the batch's one row), float32, from the port's feature operands."""
    mlp = port_mlp(c)
    with torch.no_grad():
        ops = tuple(t.detach() for t in mlp.feat_operands(*_inputs(c, torch.float32)))
    per_i, pj, h_E, geom, mask, w_in, b_in, w_mid, b_mid, w_out, b_out = ops
    H, He = c["H"], c["He"]
    w = w_in.numpy()
    j = lambda t: jnp.asarray(t[0].numpy())
    jops = (j(per_i), j(pj), j(h_E), j(geom), j(mask), jnp.asarray(w[:, H:H + He].T),
            jnp.asarray(w[:, 2 * H + He:].T), jnp.asarray(b_in.numpy()),
            jnp.asarray(w_mid.numpy().T), jnp.asarray(b_mid.numpy()),
            jnp.asarray(w_out.numpy().T), jnp.asarray(b_out.numpy()))
    return ops, jops


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_message_feat_f32_matches_pallas_kernel(graph, widths, pool):
    """Row 3: ``fused_message`` in interpret mode."""
    c = make_case(graph, *widths)
    ops, jops = _feat_operands(c)
    ours = message_feat_plain(*ops, pool)
    want = fused_message(*jops, K=c["K"], act_name="relu", pool=pool,
                         compute_dtype=jnp.float32, blk=64, interpret=True)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(want), atol=F32_MSG, rtol=0)


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_message_feat_gradients_match_jax_custom_vjp(graph, widths, pool):
    """Row 3's Function (plain forward on the CPU, recomputed backward)
    against ``jax.grad`` through ``fused_message_diff(interpret=True)``."""
    c = make_case(graph, *widths)
    H, He, K = c["H"], c["He"], c["K"]
    ops, jops = _feat_operands(c)
    rng = np.random.default_rng(5)
    cot = rng.uniform(0.5, 1.5, (L, H) if pool else (L, K, H)).astype(np.float32)
    ops = list(ops)
    diff = [i for i in range(len(ops)) if i != 4]           # operand 4 is the mask
    for i in diff:
        ops[i] = ops[i].clone().requires_grad_(True)
    out = message_feat(*ops, pool)
    grads = dict(zip(diff, torch.autograd.grad(
        0.5 * (torch.from_numpy(cot) * out[0] ** 2).sum(), [ops[i] for i in diff])))
    jdiff = (0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11)

    def jloss(*a):
        full = list(jops)
        for i, v in zip(jdiff, a):
            full[i] = v
        out = fused_message_diff(*full, K=K, act_name="relu", pool=pool, blk=64,
                                 compute_dtype=jnp.float32, interpret=True)
        return 0.5 * (jnp.asarray(cot) * out ** 2).sum()

    jg = dict(zip(jdiff, jax.grad(jloss, argnums=tuple(range(len(jdiff))))(
        *[jops[i] for i in jdiff])))
    gw_in = grads[5].numpy()
    pairs = {"per_i": (grads[0][0].numpy(), jg[0]), "pj": (grads[1][0].numpy(), jg[1]),
             "h_E": (grads[2][0].numpy(), jg[2]), "geom": (grads[3][0].numpy(), jg[3]),
             "w_he": (gw_in[:, H:H + He].T, jg[5]), "w_g": (gw_in[:, 2 * H + He:].T, jg[6]),
             "b_e": (grads[6].numpy(), jg[7]), "w1": (grads[7].numpy().T, jg[8]),
             "b1": (grads[8].numpy(), jg[9]), "w2": (grads[9].numpy().T, jg[10]),
             "b2": (grads[10].numpy(), jg[11])}
    for name, (got, want) in pairs.items():
        want = np.asarray(want)
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, atol=GRAD_REL * np.abs(want).max(), rtol=0,
                                   err_msg=name)


def _jax_layer(c, ops, pool):
    """``_fused_pass`` (float32, interpret mode) on the port's operands."""
    H, He, P, K = c["H"], c["He"], c["P"], c["K"]
    p = c["params"]
    w_e = p["Dense_e"]["kernel"]
    row = lambda a: np.asarray(a, np.float32).reshape(1, -1)
    ln_a_s, ln_a_b, f1, f1b, f2, f2b, ln_b_s, ln_b_b = c["chain"]
    weights = tuple(jnp.asarray(a, jnp.float32) for a in (
        w_e[:He], w_e[He:], row(p["Dense_e"]["bias"]), p["Dense_1"]["kernel"],
        row(p["Dense_1"]["bias"]), p["Dense_2"]["kernel"], row(p["Dense_2"]["bias"]),
        row(ln_a_s), row(ln_a_b), f1, row(f1b), f2, row(f2b), row(ln_b_s), row(ln_b_b)))
    j = lambda t, *shape: jnp.asarray(t[0].float().numpy()).reshape(*shape)
    if pool:
        h_V, per_i, pjg, h_E, geom, mask, mask_V = ops[:7]
        x, mv = j(h_V, L, H), j(mask_V, L, 1)
    else:
        h_E, per_i, pjg, geom, mask = ops[:5]
        x, mv = j(h_E, L * K, He), None
    out = _fused_pass(x, j(per_i, L, H), j(pjg, L * K, H), j(h_E, L * K, He),
                      j(geom, L * K, 9 * P), j(mask, L, K), mv, weights, pool=pool, blk=64,
                      interpret=True, K=K, act_name="relu", compute_dtype=jnp.float32,
                      stream_dtype=jnp.float32)
    out = np.asarray(out)
    return out[None] if pool else out.reshape(1, L, K, H)


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_layer_f32_matches_pallas_kernel(graph, widths, pool):
    """Row 6: the node pass at (H, He, P, K), the edge pass at He = H."""
    c = make_case(graph, *widths) if pool else _square(graph, *widths)
    mlp = port_mlp(c)
    with torch.no_grad():
        per_i, pjg, h_E, geom, mask, *msg_w = mlp.feat_operands(*_inputs(c, torch.float32))
        cw = port_chain_weights(c)
        if pool:
            mask_V = torch.ones(1, L)
            mask_V[0, -3:] = 0.0
            ops = (torch.from_numpy(c["h_V"]), per_i, pjg, h_E, geom, mask, mask_V, *msg_w, *cw)
            ours = layer_node(*ops)
        else:
            ops = (h_E, per_i, pjg, geom, mask, *msg_w, *cw)
            ours = layer_edge(*ops)
    np.testing.assert_allclose(ours.numpy(), _jax_layer(c, ops, pool), atol=F32_CHAIN, rtol=0)


# the whole network: (hidden_dim, n_points, top_k) at edge_features = hidden_dim
NETWORKS = [(64, 4, 16), (128, 8, 96)]
NET_IDS = ["H64-P4-K16", "H128-P8-K96"]


@pytest.fixture(scope="module")
def complex_feats():
    """Both chains of 1BRS (216 residues: room for 96 neighbours)."""
    return featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True))


def _widths(H, P, K, **kw):
    return dict(hidden_dim=H, node_features=H, edge_features=H, n_points=P, top_k=K, **kw)


def _jax_params(feats, jcfg):
    jb = jax_stack_batch([feats])
    return jax.tree.map(np.asarray, JaxChiScoreNetwork(jcfg).init(
        jax.random.key(3), jb, jb.SC_D, jnp.zeros(jb.residue_mask.shape), True))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 6e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
def test_network_matches_jax_network_at_width(complex_feats, net, dtype, tol):
    """The port's network (its default kernel routing, plain versions on the
    CPU) against the JAX network on the same weights, score and hidden
    state."""
    jcfg = JaxNetworkConfig(**_widths(*net), compute_dtype=dtype)
    params = _jax_params(complex_feats, jcfg)
    port = ChiScoreNetwork(NetworkConfig(**_widths(*net), compute_dtype=dtype)).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in from_flax_params(params).items()})
    jb = jax_stack_batch([complex_feats])
    rng = np.random.default_rng(0)
    sc = (np.asarray(jb.SC_D) + rng.normal(size=jb.SC_D.shape)).astype(np.float32)
    s_ref, h_ref = JaxChiScoreNetwork(jcfg).apply(params, jb, jnp.asarray(sc),
                                                  jnp.full(jb.residue_mask.shape, 0.45))
    batch = stack_batch([complex_feats], "cpu")
    with torch.no_grad():
        score, h = port(batch, torch.from_numpy(sc), torch.full(batch.residue_mask.shape, 0.45))
    np.testing.assert_allclose(score.numpy(), np.asarray(s_ref), atol=tol, rtol=0)
    np.testing.assert_allclose(h.float().numpy(), np.asarray(h_ref, np.float32), atol=tol,
                               rtol=0)


def test_two_step_sample_matches_jax_sampler_at_width(complex_feats):
    """Two ODE steps at hidden_dim = edge_features = 64, n_points = 4,
    top_k = 16 from the same initial chis, float32: within 5e-4 rad."""
    cfg = _widths(64, 4, 16)
    params = _jax_params(complex_feats, JaxNetworkConfig(**cfg))
    model = TorsionalDiffusion(NetworkConfig(**cfg))
    model.net.load_state_dict({k: torch.from_numpy(v)
                               for k, v in from_flax_params(params).items()})
    jb = jax_stack_batch([complex_feats])
    init = np.random.default_rng(2).uniform(-np.pi, np.pi, jb.SC_D.shape).astype(np.float32)
    jmodel = JaxTorsionalDiffusion.create(JaxNetworkConfig(**cfg), JaxSampleConfig(mode="ode"))
    want = np.asarray(jmodel.sample(params, jax.random.key(0), jb, n_steps=2, init_sc=init))
    got = model.sample(stack_batch([complex_feats], "cpu"), None, n_steps=2,
                       init_sc=torch.from_numpy(init)).numpy()
    mask = np.asarray(jb.SC_D_mask) > 0
    d = np.abs(got - want)
    assert np.minimum(d, 2 * np.pi - d)[mask].max() < 5e-4

"""The port's message pass (plain version, as the wrapper runs it on CPU
tensors) against the JAX package's lane-major Pallas kernel
``fused_message_geom_lanes`` in interpret mode, fed as
``FactoredMessageMLP.geom_fused_lanes`` feeds it: pool and edge, float32
and bf16, and the edge pass under each activation of the table.

Tolerances: float32 <= 2e-5 (the JAX package's own kernel-vs-unfused
bound). bf16 against the kernel: max |d| <= 2^-6 * max|ref| and mean |d|
<= 2^-10 * max|ref|. That comparison cannot see the bf16 rounding points:
the kernel's second product (``_message_chain``) takes the float32
activation, which a TPU's default matmul precision rounds to bf16 but
XLA:CPU multiplies exactly, so the port (which rounds it) reads mean |d|
2.5e-4 * max|ref| there, and the port without any rounding point 5.4e-4.

The bf16 rounding points are held instead against the JAX package's
unfused ``FactoredMessageMLP`` path, run op by op (no XLA fusion to drop a
round trip) with the neighbour term gathered in the stream dtype, as the
kernel takes it: the port reads mean |d| <= 4e-9 * max|ref| there and the
port without rounding points 5.4e-4 to 5.9e-4, so the limit is mean |d| <=
2^-16 * max|ref| (max |d| <= 2^-6 * max|ref|, one bf16 ulp at the largest
output being 2^-8), and a control test checks that it rejects the latter.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.geometry.rigid import Rigid as JaxRigid
from packppi_tpu.models.ipmp import FactoredMessageMLP as JaxMessageMLP
from packppi_tpu.models.ipmp import geometry_edge_features as jax_edge_features
from packppi_tpu.models.ipmp import geometry_global_points as jax_global_points
from packppi_tpu.ops.graph import gather_nodes as jax_gather_nodes
from packppi_tpu.ops.pallas_ipmp import (_geom_lanes_kernel, _geom_weight_perm,
                                         build_node_stack, fused_message_geom_lanes)
from packppi_torch.data import stack_batch
from packppi_torch.geometry import bb_frames_from_atom14
from packppi_torch.models.ipmp import FactoredMessageMLP
from packppi_torch.models.ipmp import MessagePassingStack
from packppi_torch.ops.graph import masked_knn
from packppi_torch.ops.message import message, message_plain
from packppi_torch.structure import featurize, from_pdb_file

from conftest import FIXTURES
from torch_threads import _threads  # noqa: F401 (autouse fixture)

H, P, K, L = 128, 8, 16, 40
BF16_MAX_REL, BF16_MEAN_REL = 2.0 ** -6, 2.0 ** -16


@pytest.fixture(scope="module")
def case():
    """Real backbone frames and kNN graph of 40 residues of 1BRS; node and
    edge states, points and weights drawn by numpy from a seed."""
    feats = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), chain_id="A"))
    feats = {k: v[:L] for k, v in feats.items()}
    batch = stack_batch([feats], "cpu", target_len=L)
    _, idx = masked_knn(batch.X[:, :, 1], batch.residue_mask, K)
    mask = MessagePassingStack.attend_mask(batch.residue_mask, idx)
    mask[0, 3, 5:] = 0.0                       # a few masked edges
    frames = bb_frames_from_atom14(batch.X)

    rng = np.random.default_rng(0)
    f32 = np.float32
    xavier = lambda i, o: (rng.uniform(-1, 1, (i, o)) * np.sqrt(6 / (i + o))).astype(f32)
    params = {
        "Dense_i": {"kernel": xavier(H, H)},
        "Dense_j": {"kernel": xavier(H, H)},
        "Dense_e": {"kernel": xavier(H + 9 * P, H), "bias": rng.normal(0, .1, H).astype(f32)},
        "Dense_1": {"kernel": xavier(H, H), "bias": rng.normal(0, .1, H).astype(f32)},
        "Dense_2": {"kernel": xavier(H, H), "bias": rng.normal(0, .1, H).astype(f32)},
    }
    return dict(
        idx=idx, mask=mask, frames=frames, params=params,
        h_V=rng.normal(size=(1, L, H)).astype(f32),
        h_E=rng.normal(size=(1, L, K, H)).astype(f32),
        p_local=(3 * rng.normal(size=(1, L, P, 3))).astype(f32))


def _port_mlp(params, act="relu"):
    mlp = FactoredMessageMLP(H, H, 9 * P, act)
    p = params
    w_in = np.concatenate([p["Dense_i"]["kernel"], p["Dense_e"]["kernel"][:H],
                           p["Dense_j"]["kernel"], p["Dense_e"]["kernel"][H:]], 0)
    sd = {"W_in.weight": w_in.T, "W_in.bias": p["Dense_e"]["bias"],
          "W_inter.0.weight": p["Dense_1"]["kernel"].T, "W_inter.0.bias": p["Dense_1"]["bias"],
          "W_out.weight": p["Dense_2"]["kernel"].T, "W_out.bias": p["Dense_2"]["bias"]}
    mlp.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return mlp


def _run_both(case, dtype, pool, act="relu"):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    mlp = _port_mlp(case["params"], act)
    with torch.no_grad():
        ours = mlp(torch.from_numpy(case["h_V"]).to(tdt), torch.from_numpy(case["h_E"]).to(tdt),
                   case["idx"], torch.from_numpy(case["p_local"]), case["frames"],
                   case["mask"], pool=pool)
    fr = case["frames"]
    ref = _jax_message(case["params"], jnp.asarray(case["h_V"], jdt),
                       jnp.asarray(case["h_E"], jdt), jnp.asarray(case["idx"].numpy()),
                       jnp.asarray(case["p_local"]), jnp.asarray(fr.rot.numpy()),
                       jnp.asarray(fr.trans.numpy()), jnp.asarray(case["mask"].numpy()),
                       pool, jdt, act)
    return ours, np.asarray(ref.astype(jnp.float32))[None]


def _jax_message(params, h_V, h_E, idx, p_local, rot, trans, mask, pool, cd, act="relu"):
    """``FactoredMessageMLP.geom_fused_lanes``'s operand preparation for one
    structure, then the Pallas kernel: float32 through
    ``fused_message_geom_lanes(interpret=True)``; bf16 through the kernel
    body ``_geom_lanes_kernel`` called eagerly on one block of all L nodes,
    because XLA:CPU cannot compile the interpreted kernel's bf16 x bf16 ->
    f32 products ("Unsupported element type for DotThunk")."""
    p, f32 = params, jnp.float32
    if cd == jnp.float32:
        mm = lambda x, k: jnp.dot(x, k)
    else:
        mm = lambda x, k: jnp.dot(x.astype(cd), k.astype(cd), preferred_element_type=f32)
    per_i = mm(h_V, p["Dense_i"]["kernel"])[0]
    pjg = jax_gather_nodes(mm(h_V, p["Dense_j"]["kernel"]).astype(h_E.dtype), idx)[0]
    pl_planes = jnp.concatenate([p_local[..., 0], p_local[..., 1], p_local[..., 2]], -1)
    norm_pl = jnp.sqrt(p_local[..., 0] ** 2 + p_local[..., 1] ** 2 + p_local[..., 2] ** 2 + 1e-8)
    pg = jax_global_points(p_local, JaxRigid(rot, trans))
    stack = build_node_stack(pl_planes, norm_pl, rot.reshape(1, L, 9), trans, pg)[0]
    ngT = jax_gather_nodes(pg, idx)[0]
    w_e = jnp.asarray(p["Dense_e"]["kernel"])
    w_he, w_g = w_e[:H], w_e[H:][_geom_weight_perm(P)]
    weights = (p["Dense_e"]["bias"], p["Dense_1"]["kernel"], p["Dense_1"]["bias"],
               p["Dense_2"]["kernel"], p["Dense_2"]["bias"])
    if cd == jnp.float32:
        return fused_message_geom_lanes(per_i, pjg, h_E[0], stack, ngT, mask[0], w_he, w_g,
                                        *weights, K=K, P=P, act_name=act, pool=pool, blk=128,
                                        compute_dtype=cd, interpret=True)

    class Out:                      # the kernel's output ref
        dtype = f32 if pool else h_E.dtype

        def __setitem__(self, key, value):
            self.value = value

    row = lambda a: jnp.asarray(a, f32).reshape(1, -1)
    b_e, w1, b1, w2, b2 = weights
    out = Out()
    _geom_lanes_kernel(per_i, pjg.reshape(L * K, H), h_E[0].reshape(L * K, H), stack, ngT.reshape(L * K, -1),
                       mask[0], w_he, w_g.T, row(b_e), jnp.asarray(w1), row(b1), jnp.asarray(w2), row(b2), out,
                       K=K, P=P, act_name=act, pool=pool, compute_dtype=cd)
    return out.value if pool else out.value.reshape(L, K, H)


def _jax_unfused_bf16(case, pool):
    """The JAX package's unfused bf16 message path, op by op, with the
    neighbour term gathered in bf16 (``pjg``) as the kernel takes it."""
    bf = jnp.bfloat16
    fr = case["frames"]
    frames = JaxRigid(jnp.asarray(fr.rot.numpy()), jnp.asarray(fr.trans.numpy()))
    idx = jnp.asarray(case["idx"].numpy())
    p_local = jnp.asarray(case["p_local"])
    geom = jax_edge_features(p_local, jax_gather_nodes(jax_global_points(p_local, frames), idx),
                             frames)
    mlp = JaxMessageMLP(H, H, 9 * P, dtype=bf)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, case["params"])}
    h_V, h_E = jnp.asarray(case["h_V"], bf), jnp.asarray(case["h_E"], bf)
    pjg = jax_gather_nodes(mlp.apply(variables, h_V, method=JaxMessageMLP.per_j_term).astype(bf),
                           idx)
    out = mlp.apply(variables, h_V, h_E, idx, geom, jnp.asarray(case["mask"].numpy()),
                    pool=pool, pjg=pjg)
    return np.asarray((out if pool else out.astype(bf)).astype(jnp.float32))


def _bf16_readings(got, ref):
    """(max |d|, mean |d|) relative to max|ref|."""
    d = np.abs(got - ref)
    scale = np.abs(ref).max()
    return d.max() / scale, d.mean() / scale


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
def test_message_f32_matches_pallas_kernel(case, pool):
    ours, ref = _run_both(case, "float32", pool)
    assert ours.dtype == torch.float32
    assert ours.shape == ((1, L, H) if pool else (1, L, K, H))
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
def test_message_bf16_matches_pallas_kernel(case, pool):
    ours, ref = _run_both(case, "bfloat16", pool)
    assert ours.dtype == (torch.float32 if pool else torch.bfloat16)
    d = np.abs(ours.float().numpy() - ref)
    scale = np.abs(ref).max()
    assert d.max() <= 2.0 ** -6 * scale, (d.max(), scale)
    assert d.mean() <= 2.0 ** -10 * scale, (d.mean(), scale)


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
def test_message_bf16_matches_unfused_path(case, pool):
    ours, _ = _run_both(case, "bfloat16", pool)
    dmax, dmean = _bf16_readings(ours.float().numpy(), _jax_unfused_bf16(case, pool))
    assert dmax <= BF16_MAX_REL and dmean <= BF16_MEAN_REL, (dmax, dmean)


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
def test_message_bf16_tolerance_rejects_unrounded(case, pool):
    """The control: the port's message with no bf16 rounding point (run in
    float32 on the bf16 inputs; the edge output written in bf16) must fail
    the mean limit."""
    mlp = _port_mlp(case["params"])
    with torch.no_grad():
        control = mlp(torch.from_numpy(case["h_V"]).bfloat16().float(),
                      torch.from_numpy(case["h_E"]).bfloat16().float(), case["idx"],
                      torch.from_numpy(case["p_local"]), case["frames"], case["mask"], pool=pool)
    control = control if pool else control.bfloat16()
    _, dmean = _bf16_readings(control.float().numpy(), _jax_unfused_bf16(case, pool))
    assert dmean > 4 * BF16_MEAN_REL, dmean


ACTS = ["relu", "gelu", "elu", "selu", "celu", "leaky_relu", "silu", "sigmoid"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_message_activation_matches_pallas_kernel(case, act, dtype):
    """Every activation of the table (``act_name`` of the JAX kernel), on the
    edge pass: float32 within 2e-5; bf16 at the kernel comparison's limits
    above. The activations differ enough to be told apart."""
    ours, ref = _run_both(case, dtype, False, act)
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5, rtol=0)
    else:
        d = np.abs(ours.float().numpy() - ref)
        scale = np.abs(ref).max()
        assert d.max() <= 2.0 ** -6 * scale and d.mean() <= 2.0 ** -10 * scale, (d.max(), scale)
    if act != "relu":
        assert np.abs(ours.float().numpy() - _run_both(case, dtype, False)[0].float().numpy()
                      ).max() > 1e-2


def test_wrapper_takes_plain_version_on_cpu(case):
    mlp = _port_mlp(case["params"])
    ops = mlp.operands(torch.from_numpy(case["h_V"]), torch.from_numpy(case["h_E"]),
                       case["idx"], torch.from_numpy(case["p_local"]), case["frames"],
                       case["mask"])
    before = message.launches
    with torch.no_grad():
        out = message(*ops, True)
        np.testing.assert_array_equal(out.numpy(), message_plain(*ops, True).numpy())
    assert message.launches == before      # only kernel launches count

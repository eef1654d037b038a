"""The port's training step on the CPU against the JAX package's: the loss
and its parameter gradients on converted weights with the JAX package's own
time and noise draws fed in, the optimizer against ``optax.adamw``, the
non-finite skip, the EMA and the learning-rate schedule.

Tolerances: loss 1e-5; each parameter gradient within 5e-4 of its max (the
JAX package's fused-vs-unfused limit); parameters after three AdamW steps
1e-6; the schedule 1e-9 relative.
"""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import packppi_tpu.ops.pallas_layer as pallas_layer
from packppi_tpu.data import stack_batch as jax_stack_batch
from packppi_tpu.models import NetworkConfig as JaxNetworkConfig
from packppi_tpu.models import SampleConfig as JaxSampleConfig
from packppi_tpu.models import TorsionalDiffusion as JaxTorsionalDiffusion
from packppi_tpu.models.diffusion_net import ChiScoreNetwork as JaxChiScoreNetwork
from packppi_tpu.models.ipmp import FactoredMessageMLP as JaxMessageMLP
from packppi_tpu.train import loop as jax_loop
from packppi_tpu.train.diffusion_task import make_ema_update as jax_make_ema_update
from packppi_torch.data import stack_batch
from packppi_torch.models import NetworkConfig, TorsionalDiffusion
from packppi_torch.ops.chain import chain
from packppi_torch.ops.message_feat import message_feat
from packppi_torch.structure import featurize, from_pdb_file
from packppi_torch.train.diffusion_task import (init_state, make_ema_update, make_optimizer,
                                                make_train_step)
from packppi_torch.train.loop import make_lr
from packppi_torch.utils.config import Config
from packppi_torch.weights import from_flax_params, load_weights

from conftest import FIXTURES
from test_torch_so2 import _table_cache, jax_schedule  # noqa: F401 (autouse fixture)
from torch_threads import _threads  # noqa: F401 (autouse fixture)

KNOBS = dict(fused_messages=True, fused_messages_train=True, fused_chain_train=True)
SMALL = dict(top_k=16)        # 16 neighbours: half the edge rows, the same code paths


@pytest.fixture(scope="module")
def feats():
    """Two small proteins of unequal length (52 and 40 residues of 1BRS),
    so the batch has padded rows."""
    a = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), chain_id="A",
                                mse_to_met=True))
    d = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), chain_id="D",
                                mse_to_met=True))
    return [{k: v[:52] for k, v in a.items()}, {k: v[10:50] for k, v in d.items()}]


@pytest.fixture(scope="module")
def jax_side(feats):
    """The JAX batch, an init tree, the draws ``loss`` makes from one key,
    and the loss and gradients of the unfused dropout-0 configuration and of
    the configuration that trains through the Pallas kernels (interpreted)."""
    jb = jax_stack_batch(feats)

    def model(**kw):
        return JaxTorsionalDiffusion(
            net=JaxChiScoreNetwork(JaxNetworkConfig(dropout=0.0, **SMALL, **kw)),
            schedule_pi=jax_schedule(True, mode="ode"), schedule_2pi=jax_schedule(False, mode="ode"),
            sample_cfg=JaxSampleConfig())

    unfused = model()
    params = unfused.init(jax.random.key(0), jb)
    key = jax.random.key(7)
    # the draws of TorsionalDiffusion.loss and add_chi_noise from this key
    kt, kn, _ = jax.random.split(key, 3)
    k1, k2 = jax.random.split(kn)
    B = jb.residue_mask.shape[0]
    draws = dict(t=np.asarray(jax.random.uniform(kt, (B,))),
                 noise_pi=np.asarray(jax.random.normal(k1, jb.SC_D.shape, jb.SC_D.dtype)),
                 noise_2pi=np.asarray(jax.random.normal(k2, jb.SC_D.shape, jb.SC_D.dtype)))

    out = {"unfused": jax.value_and_grad(lambda p: unfused.loss(p, key, jb))(params)}
    fused = model(**KNOBS)
    orig = JaxMessageMLP.__call__

    def interpreted(self, *args, **kw):
        kw["interpret"] = True
        return orig(self, *args, **kw)

    prev, pallas_layer.INTERPRET = pallas_layer.INTERPRET, True
    try:
        with mock.patch.object(JaxMessageMLP, "__call__", interpreted):
            out["kernels"] = jax.value_and_grad(lambda p: fused.loss(p, key, jb))(params)
    finally:
        pallas_layer.INTERPRET = prev
    return params, draws, out


def _port_model(params, **kw):
    model = TorsionalDiffusion(NetworkConfig(dropout=0.0, **SMALL, **kw))
    load_weights(model.net, from_flax_params(jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.mark.parametrize("config", ["unfused", "kernels"])
def test_loss_and_gradients_match_jax(feats, jax_side, config):
    params, draws, ref = jax_side
    want_loss, want_grads = ref[config]
    model = _port_model(params, **(KNOBS if config == "kernels" else {}))
    batch = stack_batch(feats, "cpu")
    counts = message_feat.launches, chain.launches
    loss = model.loss(batch, None, **{k: torch.tensor(v) for k, v in draws.items()})
    loss.backward()
    assert (message_feat.launches, chain.launches) == counts     # CPU: plain versions
    assert not model.net.training                                # loss leaves eval mode on
    assert abs(loss.item() - float(want_loss)) <= 1e-5, (loss.item(), float(want_loss))

    want = from_flax_params(jax.tree_util.tree_map(np.asarray, want_grads))
    got = {k: (np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy())
           for k, p in model.net.named_parameters()}
    assert set(got) == set(want)
    moved = 0
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-3)
        np.testing.assert_allclose(got[name], w, atol=5e-4 * scale, rtol=0, err_msg=name)
        moved += bool(np.abs(w).max() > 0)
    assert moved == len(want) - 16          # all but the last layer's dead edge pass


def test_loss_draws_from_the_generator_and_validation_is_repeatable(feats, jax_side):
    model = _port_model(jax_side[0])
    batch = stack_batch(feats, "cpu")
    with torch.no_grad():
        a = model.loss(batch, torch.Generator().manual_seed(1), deterministic=True)
        b = model.loss(batch, torch.Generator().manual_seed(1), deterministic=True)
        c = model.loss(batch, torch.Generator().manual_seed(2), deterministic=True)
    assert float(a) == float(b) != float(c) and np.isfinite(float(c))


def test_dropout_configuration_trains_on_the_unfused_path(feats):
    """The default configuration (dropout 0.1, no training knob): a training
    loss draws dropout, a deterministic one does not."""
    model = TorsionalDiffusion(NetworkConfig())
    state = init_state(model, 0, "cpu")
    batch = stack_batch(feats, "cpu")
    fixed = dict(t=torch.tensor([0.3, 0.6]), noise_pi=torch.zeros(batch.SC_D.shape),
                 noise_2pi=torch.ones(batch.SC_D.shape))
    torch.manual_seed(0)
    a = model.loss(batch, None, **fixed).item()
    b = model.loss(batch, None, **fixed).item()
    with torch.no_grad():
        c = model.loss(batch, None, deterministic=True, **fixed).item()
        d = model.loss(batch, None, deterministic=True, **fixed).item()
    assert a != b and c == d
    assert state.step == 0


@pytest.mark.parametrize("knobs", [{}, KNOBS], ids=["unfused", "kernels"])
def test_remat_layers_recomputes_the_same_gradients(feats, knobs):
    """``remat_layers`` checkpoints each message-passing layer in training:
    the same loss, the same gradients (the recomputation repeats the same
    float32 operations), with dropout 0 and with dropout's draws replayed."""
    batch = stack_batch(feats, "cpu")
    fixed = dict(t=torch.tensor([0.3, 0.6]), noise_pi=torch.full(batch.SC_D.shape, 0.2),
                 noise_2pi=torch.full(batch.SC_D.shape, -0.7))
    results = []
    for remat in (False, True):
        cfg = NetworkConfig(dropout=0.0, **knobs) if knobs else NetworkConfig(dropout=0.1)
        model = TorsionalDiffusion(NetworkConfig(**{**cfg.__dict__, "remat_layers": remat}))
        init_state(model, 4, "cpu")
        torch.manual_seed(0)                       # dropout's draws (unfused configuration)
        loss = model.loss(batch, None, **fixed)
        loss.backward()
        results.append((loss.item(), {k: p.grad.clone() for k, p in model.net.named_parameters()
                                      if p.grad is not None}))
    assert results[0][0] == results[1][0]
    assert results[0][1].keys() == results[1][1].keys()
    for k, g in results[0][1].items():
        np.testing.assert_allclose(results[1][1][k].numpy(), g.numpy(), atol=1e-7, rtol=0,
                                   err_msg=k)


def test_adamw_matches_optax(feats):
    """Three updates from the same gradients."""
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    tx = optax.adamw(1e-4, weight_decay=1e-12)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = make_optimizer(tp.values())
    for g in grads:
        updates, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, updates)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
        assert np.abs(tp[k].detach().numpy() - p0[k]).max() > 1e-4      # it moved


def _snapshot(state):
    params = {k: v.clone() for k, v in state.params.items()}
    opt = {i: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
           for i, s in enumerate(state.optimizer.state.values())}
    return params, opt


def _equal(a, b):
    (pa, oa), (pb, ob) = a, b
    return (all(torch.equal(pa[k], pb[k]) for k in pa) and oa.keys() == ob.keys()
            and all(torch.equal(oa[i][k], ob[i][k]) if torch.is_tensor(oa[i][k])
                    else oa[i][k] == ob[i][k] for i in oa for k in oa[i]))


def test_train_step_updates_and_non_finite_loss_is_skipped(feats):
    model = TorsionalDiffusion(NetworkConfig(dropout=0.0, **KNOBS))
    state = init_state(model, 3, "cpu")
    step = make_train_step(model, state.optimizer)
    batch = stack_batch(feats, "cpu")
    before = _snapshot(state)
    loss = step(state, batch)
    assert np.isfinite(float(loss)) and (state.step, state.opt_steps) == (1, 1)
    after = _snapshot(state)
    assert not _equal(before, after)

    X = batch.X.clone()
    X[0, 5, 1, 0] = float("nan")                  # one poisoned coordinate
    gen_before = state.generator.get_state().clone()
    loss = step(state, batch._replace(X=X))
    assert not np.isfinite(float(loss))
    assert _equal(after, _snapshot(state))         # parameters and Adam state, bit for bit
    assert (state.step, state.opt_steps) == (2, 1)
    assert not torch.equal(gen_before, state.generator.get_state())   # the draw was made
    assert all(p.grad is None for p in model.net.parameters())
    assert np.isfinite(float(step(state, batch))) and state.opt_steps == 2


def test_grad_accumulation_averages_micro_batches(feats):
    """Two micro-batches at accumulation 2 make one update, equal to the
    update from the mean of their gradients."""
    batch = stack_batch(feats, "cpu")
    draws = [dict(t=torch.tensor([0.2, 0.7]), noise_pi=torch.full(batch.SC_D.shape, 0.3),
                  noise_2pi=torch.full(batch.SC_D.shape, -0.4)),
             dict(t=torch.tensor([0.5, 0.1]), noise_pi=torch.full(batch.SC_D.shape, -1.0),
                  noise_2pi=torch.full(batch.SC_D.shape, 0.8))]
    results = []
    for accum in (2, 1):
        model = TorsionalDiffusion(NetworkConfig(dropout=0.0))
        state = init_state(model, 5, "cpu")
        if accum == 2:
            step = make_train_step(model, state.optimizer, grad_accum_steps=2)
            for d in draws:
                step(state, batch, **d)
            assert (state.step, state.opt_steps) == (2, 1)
        else:
            loss = sum(model.loss(batch, None, **d) for d in draws) / 2
            loss.backward()
            state.optimizer.step()
        results.append({k: v.clone() for k, v in state.params.items()})
    for k in results[0]:
        np.testing.assert_allclose(results[0][k].numpy(), results[1][k].numpy(), atol=1e-7,
                                   rtol=0, err_msg=k)


def test_state_dict_round_trip_resumes_exactly(feats, tmp_path):
    from packppi_torch.train.checkpoints import load_model_params, load_params, save_params

    batch = stack_batch(feats, "cpu")
    model = TorsionalDiffusion(NetworkConfig(dropout=0.0))
    state = init_state(model, 9, "cpu")
    step = make_train_step(model, state.optimizer)
    step(state, batch)
    save_params(tmp_path / "state.pt", state.state_dict())
    want = [float(step(state, batch)) for _ in range(2)]

    model2 = TorsionalDiffusion(NetworkConfig(dropout=0.0))
    state2 = init_state(model2, 1234, "cpu")
    state2.load_state_dict(load_params(tmp_path / "state.pt"))
    step2 = make_train_step(model2, state2.optimizer)
    got = [float(step2(state2, batch)) for _ in range(2)]
    assert got == want and state2.step == 3

    # the full train state unwraps to the network's weights; a params-only file loads as it is
    sd = load_model_params(tmp_path / "state.pt", model.net.state_dict())
    assert set(sd) == set(model.net.state_dict())
    save_params(tmp_path / "params.pt", {k: v for k, v in model.net.state_dict().items()})
    assert set(load_model_params(tmp_path / "params.pt")) == set(sd)
    with pytest.raises(ValueError, match="does not match"):
        load_model_params(tmp_path / "params.pt", {"x": torch.zeros(1)})


def test_ema_matches_jax():
    rng = np.random.default_rng(0)
    ema = {"a": rng.normal(size=(4, 3)).astype(np.float32)}
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32)}
    want = jax_make_ema_update(0.99)({k: jnp.asarray(v) for k, v in ema.items()},
                                     {k: jnp.asarray(v) for k, v in params.items()})
    t_ema = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    t_par = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    got = make_ema_update(0.99)(t_ema, t_par)
    assert got is t_ema and got["a"].data_ptr() != t_par["a"].data_ptr()
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), atol=1e-7, rtol=0)


@pytest.mark.parametrize("warmup,accum", [(0, 1), (5, 1), (5, 2)])
def test_make_lr_matches_optax_schedule(warmup, accum):
    cfg = Config.wrap(dict(lr=3e-4, lr_schedule="cosine", warmup_steps=warmup,
                           grad_accum_steps=accum, max_epochs=4))
    ours, ref = make_lr(cfg, 11), jax_loop.make_lr(cfg, 11)
    for count in (0, 1, 2, 4, 5, 6, 10, 21, 43, 44, 60):
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12), count
    const = Config.wrap(dict(lr=3e-4, lr_schedule="constant", max_epochs=4))
    assert make_lr(const, 11) == jax_loop.make_lr(const, 11) == 3e-4
    with pytest.raises(ValueError, match="lr_schedule"):
        make_lr(Config.wrap(dict(lr=1e-4, lr_schedule="linear", max_epochs=1)), 3)

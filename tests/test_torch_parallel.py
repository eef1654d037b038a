"""The port's distribution layer (``packppi_torch.parallel``) without ranks:
the FSDP rule on every parameter of the network and ESM-2's tensor-parallel
layout against the JAX package's shardings, and the kernel wrappers'
device-guarded launch. The checks that start ranks (the GPipe schedule,
ESM-2 under tensor and pipeline parallelism, every entry point) are in
``tests/test_torch_multidevice.py``, one file, so the test runner keeps every
spawned rank on one worker.
"""
import ast
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.models import NetworkConfig as JaxNetworkConfig
from packppi_tpu.models.diffusion_net import ChiScoreNetwork as JaxChiScoreNetwork
from packppi_tpu.models.esm2 import ESM2Config as JaxESM2Config
from packppi_tpu.models.esm2 import esm2_param_shardings
from packppi_tpu.parallel import make_mesh, param_shardings
from packppi_torch.models import ChiScoreNetwork, NetworkConfig
from packppi_torch.models.esm2 import ESM2, ESM2Config, esm2_tp_shards
from packppi_torch.parallel import param_shards
from packppi_torch.weights import esm_from_jax_params, from_flax_params

from __graft_entry__ import _synthetic_batch
from torch_threads import _threads  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 virtual devices")

REPO = Path(__file__).resolve().parent.parent
ESM = dict(hidden_size=64, num_layers=4, num_heads=4, intermediate_size=128)


@pytest.fixture(scope="module")
def esm_case():
    rng = np.random.default_rng(7)
    cfg = JaxESM2Config(**ESM)
    nl, hd, it = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    r = lambda *s: jnp.asarray(rng.normal(0.0, 0.1, s), jnp.float32)
    params = {
        "embedding": r(cfg.vocab_size, hd), "final_ln_scale": jnp.ones(hd) + r(hd) * 0.1,
        "final_ln_bias": r(hd),
        "layers": {"wq": r(nl, hd, hd), "bq": r(nl, hd), "wk": r(nl, hd, hd), "bk": r(nl, hd),
                   "wv": r(nl, hd, hd), "bv": r(nl, hd), "wo": r(nl, hd, hd), "bo": r(nl, hd),
                   "w1": r(nl, hd, it), "b1": r(nl, it), "w2": r(nl, it, hd), "b2": r(nl, hd),
                   "ln1_scale": jnp.ones((nl, hd)), "ln1_bias": r(nl, hd) * 0.1,
                   "ln2_scale": jnp.ones((nl, hd)), "ln2_bias": r(nl, hd) * 0.1}}
    B, T = 4, 24
    ids = rng.integers(4, 31, size=(B, T)).astype(np.int64)
    ids[:, 0] = 0
    ids[2, 5:] = 1                                    # padding
    mask = (ids != 1).astype(np.float32)
    ids[1, 3] = 32                                    # a <mask> token
    return cfg, params, ids, mask


# ---- the FSDP rule -----------------------------------------------------------

def _axis_labels(tree, specs):
    """numpy leaves that vary only along the axis a spec shards (-1 where
    replicated), so a layout conversion shows where that axis went."""
    def label(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        if "model" not in spec:
            return np.full(leaf.shape, -1.0, np.float32)
        a = spec.index("model")
        shape = [1] * leaf.ndim
        shape[a] = leaf.shape[a]
        return np.broadcast_to(np.arange(leaf.shape[a], dtype=np.float32).reshape(shape),
                               leaf.shape).copy()

    return jax.tree_util.tree_map(label, tree, specs)


def _varying_axis(arr):
    if (arr == -1).all():
        return None
    axes = [k for k in range(arr.ndim) if arr.shape[k] > 1 and (np.diff(arr, axis=k) != 0).any()]
    assert len(axes) == 1, axes
    return axes[0]


def test_param_shards_pick_the_jax_rules_axis_network():
    """For every parameter of the 1.44 M network: the torch axis that holds
    the axis JAX ``param_shardings`` shards over model = 2."""
    mesh = make_mesh(4, model_parallel=2)
    params = jax.eval_shape(lambda: JaxChiScoreNetwork(JaxNetworkConfig()).init(
        jax.random.key(0), _synthetic_batch(B=1, L=64), jnp.zeros((1, 64, 4)),
        jnp.zeros((1, 64))))
    labels = from_flax_params(_axis_labels(params, param_shardings(mesh, params)))
    ours = param_shards(ChiScoreNetwork(NetworkConfig()), 2)
    assert set(ours) == set(labels)
    want = {k: _varying_axis(v) for k, v in labels.items()}
    assert ours == want
    assert sum(a is not None for a in ours.values()) >= 20


def test_param_shards_pick_the_jax_rules_axis_esm2(esm_case):
    """The same for ESM-2's tensor parallelism (``esm2_param_shardings``):
    q/k/v and FFN-in on their output axis, the two output projections on
    their input axis, the rest replicated."""
    cfg, params, _, _ = esm_case
    mesh = make_mesh(4, model_parallel=2)
    labels = esm_from_jax_params(_axis_labels(params, esm2_param_shardings(mesh, params)))
    ours = esm2_tp_shards(ESM2(ESM2Config(**ESM)))
    assert set(ours) == set(labels)
    assert ours == {k: _varying_axis(v) for k, v in labels.items()}


def test_shard_axis_counts_the_jax_layout():
    from packppi_torch.parallel.mesh import shard_axis

    assert shard_axis((128, 512), 2) == 1                 # largest divisible axis
    assert shard_axis((129, 512), 4) == 1
    assert shard_axis((512, 512), 2) == 0                 # the first of equal ones
    assert shard_axis((127, 129), 2) is None              # none divisible
    assert shard_axis((64, 128), 2) is None               # below 16,384 elements
    lin = torch.nn.Linear(512, 128)                       # [out, in] = [128, 512]
    assert param_shards(lin, 2) == {"weight": 1, "bias": None}


# ---- the kernel wrappers' launch helper --------------------------------------

def test_every_kernel_entry_call_goes_through_the_device_guard():
    """No wrapper of ``packppi_torch/ops`` calls a library entry point
    (``lib.packppi_*`` or ``getattr(lib, ...)(...)``) itself: every launch
    goes through ``_build.launch_kernel``, which makes the operands' device
    current."""
    calls = {}
    for path in sorted((REPO / "packppi_torch" / "ops").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            direct = (isinstance(f, ast.Attribute) and f.attr.startswith("packppi_")
                      and f.attr != "packppi_error_string")
            indirect = (isinstance(f, ast.Call) and isinstance(f.func, ast.Name)
                        and f.func.id == "getattr")
            if direct or indirect:
                calls.setdefault(path.name, []).append(node.lineno)
            if isinstance(f, ast.Attribute) and f.attr == "launch_kernel":
                calls.setdefault("launch_kernel", []).append(path.name)
    assert set(calls.pop("launch_kernel")) == {"attention.py", "chain.py", "clash.py", "gemm.py",
                                               "layer.py", "message.py", "message_feat.py"}
    assert calls == {"_build.py": calls.get("_build.py", [])}
    assert len(calls["_build.py"]) == 1                   # the helper's own call


def test_launch_helper_makes_the_operands_device_current(monkeypatch):
    """A wrapper called with operands on cuda:1 while cuda:0 is current:
    the entry point runs with cuda:1 current and gets cuda:1's stream."""
    from packppi_torch.ops import _build

    current = ["cuda:0"]
    seen = []

    @contextlib.contextmanager
    def device(d):
        before = current[0]
        current[0] = str(d)
        try:
            yield
        finally:
            current[0] = before

    class Lib:
        def packppi_mha(self, *args):
            seen.append((current[0], args[-1]))
            return 0

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_build, "stream_ptr", lambda d: f"stream of {d}")
    _build.launch_kernel(Lib(), "packppi_mha", "attention kernel launch",
                         torch.device("cuda", 1), 1, 2)
    assert seen == [("cuda:1", "stream of cuda:1")]
    assert current == ["cuda:0"]

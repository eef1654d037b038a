"""The port's ESM-2 (``models.esm2``, ``data.esm``, the ESM weight mapping of
``weights``) against the JAX package's ESM-2 and a random HuggingFace
``EsmModel``, on the CPU, at a tiny width (3 layers, hidden 64, 4 heads).

Tolerances. Against ``esm2_forward`` in float32: 2e-5 absolute with 1e-5
relative (the same operations; the order of the float32 sums differs).
Against HuggingFace per unpadded row: 2e-4 with 1e-4 relative, the JAX
package's own limit (``tests/test_esm2_jax.py``): transformers 4.57 rescales
token dropout by the padded length and keeps padding embeddings, unlike
fair-esm, so only unpadded rows are comparable. In bf16 the port rounds the
outputs of its linear maps to bf16 where the JAX package keeps them in
float32: against the JAX bf16 forward, max |d| <= 0.05 of max|ref| (the JAX
package's own bf16 limit against float32) and mean |d| <= 2^-8 of it.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from packppi_tpu.models.esm2 import ESM2Config as JaxConfig
from packppi_tpu.models.esm2 import convert_hf_esm, esm2_forward
from packppi_tpu.models.esm2 import tokenize as jax_tokenize
from packppi_torch.models.esm2 import (CLS_ID, EOS_ID, MASK_ID, PAD_ID, ESM2, ESM2Config,
                                       init_esm_weights, make_extractor, tokenize)
from packppi_torch.weights import esm_from_jax_params, load_esm_state_dict

from torch_threads import _threads  # noqa: F401 (autouse fixture)

os.environ.setdefault("USE_TF", "0")      # transformers need not import TensorFlow here
transformers = pytest.importorskip("transformers")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_hf_esm_to_torch import convert_model  # noqa: E402

TINY = dict(hidden_size=64, num_layers=3, num_heads=4, intermediate_size=128)


@pytest.fixture(scope="module")
def hf_model():
    from transformers import EsmConfig
    from transformers.models.esm.modeling_esm import EsmModel

    torch.manual_seed(0)
    cfg = EsmConfig(vocab_size=33, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                    intermediate_size=128, max_position_embeddings=512,
                    position_embedding_type="rotary", token_dropout=True,
                    emb_layer_norm_before=False, pad_token_id=PAD_ID, mask_token_id=MASK_ID,
                    layer_norm_eps=1e-5, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0, attn_implementation="eager")
    return EsmModel(cfg, add_pooling_layer=False).eval()


@pytest.fixture(scope="module")
def ported(hf_model):
    model = ESM2(ESM2Config(**TINY)).eval()
    load_esm_state_dict(model, hf_model.state_dict())
    return model


@pytest.fixture(scope="module")
def batch():
    """Three rows: full, 7 and 15 tokens of padding; mask tokens in two."""
    rng = np.random.default_rng(1)
    B, T = 3, 40
    ids = rng.integers(4, 31, size=(B, T)).astype(np.int64)
    ids[:, 0] = CLS_ID
    mask = np.zeros((B, T), np.int64)
    for b, n in enumerate((T, T - 7, T - 15)):
        ids[b, n - 1] = EOS_ID
        ids[b, n:] = PAD_ID
        mask[b, :n] = 1
    ids[0, 5] = MASK_ID
    ids[1, [3, 9, 12]] = MASK_ID
    return ids, mask


def _forward(model, ids, mask):
    with torch.no_grad():
        return model(torch.from_numpy(ids), torch.from_numpy(mask).float()).numpy()


@pytest.mark.parametrize("seq", [
    "MKV" + "<pad>" * 20 + "A<mask>CJ",
    "<mask>LAGV" + "<pad>" * 3 + "BUZO.-X" + "<null_1><unk>",
    "ACDEFGHIKLMNPQRSTVWY<cls><eos>",
])
def test_tokenize_matches_jax(seq):
    for special in (True, False):
        got, want = tokenize(seq, special), jax_tokenize(seq, special)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_forward_matches_jax_esm2_forward(hf_model, ported, batch):
    ids, mask = batch
    jcfg = JaxConfig(**TINY)
    want = np.asarray(esm2_forward(convert_hf_esm(hf_model.state_dict(), jcfg),
                                   ids.astype(np.int32), mask.astype(np.float32), jcfg))
    np.testing.assert_allclose(_forward(ported, ids, mask), want, atol=2e-5, rtol=1e-5)


def test_forward_matches_hf_per_unpadded_row(hf_model, ported, batch):
    ids, mask = batch
    out = _forward(ported, ids, mask)
    for b in range(ids.shape[0]):
        n = int(mask[b].sum())
        with torch.inference_mode():
            ref = hf_model(input_ids=torch.tensor(ids[b:b + 1, :n]),
                           attention_mask=torch.ones((1, n), dtype=torch.long)
                           ).last_hidden_state[0].numpy()
        np.testing.assert_allclose(out[b, :n], ref, atol=2e-4, rtol=1e-4, err_msg=f"row {b}")


def test_bfloat16_forward_is_close_to_jax_bfloat16(hf_model, batch):
    ids, mask = batch
    jcfg = JaxConfig(**TINY, compute_dtype="bfloat16")
    want = np.asarray(esm2_forward(convert_hf_esm(hf_model.state_dict(), jcfg),
                                   ids.astype(np.int32), mask.astype(np.float32), jcfg))
    model = ESM2(ESM2Config(**TINY, compute_dtype="bfloat16")).eval()
    load_esm_state_dict(model, hf_model.state_dict())
    got = _forward(model, ids, mask)
    m = mask.astype(bool)
    d, scale = np.abs(got[m] - want[m]), np.abs(want[m]).max()
    assert d.max() <= 0.05 * scale and d.mean() <= 2.0 ** -8 * scale, (d.max(), d.mean(), scale)


def test_jax_param_mapping_round_trips(hf_model):
    sd = {k: v.numpy() for k, v in hf_model.state_dict().items()}
    mapped = esm_from_jax_params(convert_hf_esm(sd, JaxConfig(**TINY)))
    assert set(mapped) <= set(sd)
    for k, v in mapped.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    # what the mapping leaves out is exactly what the port's loader skips
    assert sorted(set(sd) - set(mapped)) == sorted(
        k for k in sd if k.startswith(("pooler.", "contact_head."))
        or k == "embeddings.position_ids" or k.endswith(".rotary_embeddings.inv_freq"))


def test_loader_is_strict_about_the_keys_it_reads(hf_model):
    sd = dict(hf_model.state_dict())
    model = ESM2(ESM2Config(**TINY))
    load_esm_state_dict(model, {**sd, "pooler.dense.weight": torch.zeros(64, 64),
                                "contact_head.regression.weight": torch.zeros(1, 12)})
    missing = {k: v for k, v in sd.items() if k != "encoder.layer.2.output.dense.bias"}
    with pytest.raises(RuntimeError, match="output.dense.bias"):
        load_esm_state_dict(model, missing)
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_esm_state_dict(model, {**sd, "encoder.layer.0.attention.extra": torch.zeros(1)})


def test_attention_impls_on_the_cpu(ported, batch):
    ids, mask = batch
    dense = ESM2(ESM2Config(**TINY, attention_impl="dense")).eval()
    dense.load_state_dict(ported.state_dict())
    auto = ESM2(ESM2Config(**TINY, attention_impl="auto")).eval()
    auto.load_state_dict(ported.state_dict())
    np.testing.assert_array_equal(_forward(auto, ids, mask), _forward(dense, ids, mask))
    flash = ESM2(ESM2Config(**TINY, attention_impl="flash")).eval()
    with pytest.raises(RuntimeError, match="CUDA"):
        _forward(flash, ids, mask)
    with pytest.raises(ValueError, match="attention_impl"):
        ESM2(ESM2Config(**TINY, attention_impl="pallas"))


def test_random_init_is_seeded_and_follows_hf():
    a, b = ESM2(ESM2Config(**TINY)), ESM2(ESM2Config(**TINY))
    init_esm_weights(a, 3)
    init_esm_weights(b, 3)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    emb = a.embeddings.word_embeddings.weight
    assert emb[PAD_ID].abs().sum() == 0 and abs(emb[4:].std().item() - 0.02) < 2e-3
    layer = a.encoder.layer[0]
    assert layer.attention.self.query.bias.abs().sum() == 0
    assert torch.equal(layer.LayerNorm.weight, torch.ones(64))


def test_make_extractor_pads_to_128_and_strips_nothing(ported):
    ids = tokenize("MKVLA" + "<pad>" * 2 + "WCY")
    (out,) = make_extractor(ported)([ids])
    assert out.shape == (len(ids), 64) and out.dtype == np.float32
    np.testing.assert_allclose(out, _forward(ported, ids[None].astype(np.int64),
                                             np.ones((1, len(ids)), np.int64))[0],
                               atol=2e-5, rtol=1e-5)


def test_extractor_end_to_end_matches_jax(hf_model, tmp_path, monkeypatch):
    """Chain-separated sequence, tokenizer, forward, cls/eos strip, pads
    dropped and residues realigned: the port's model over the converted
    ``.pt`` file, read at ``residue_tokens``' rows, against the JAX
    extractor over the same HuggingFace model, with chain ids that are not
    non-decreasing and a masked residue."""
    import packppi_tpu.data.esm as jax_esm
    from packppi_torch.data import esm as port_esm

    path = tmp_path / "esm_tiny.pt"
    convert_model(hf_model, path)
    monkeypatch.setattr(transformers.EsmModel, "from_pretrained",
                        classmethod(lambda cls, *a, **k: hf_model))
    jax_esm._extractor_cache.clear()
    ex_jax = jax_esm.get_esm_extractor(backend="jax")
    run_tokens = make_extractor(port_esm.load_esm_model(path, "cpu"))
    assert port_esm.load_esm_model(tmp_path / "absent.pt", "cpu") is None

    def ex_port(restypes, chains, mp):
        ids, rows = port_esm.residue_tokens(restypes, chains, mp)
        return run_tokens([ids])[0][rows]

    restypes = np.array([12, 11, 19, 0, 4, 3, 5, 12, 11, 7], np.int64)
    chains = np.array([1, 1, 1, 0, 1, 1, 2, 2, 2, 2], np.int64)   # residue 3 lost its chain id
    mask_pos = np.zeros(10, bool)
    mask_pos[5] = True
    for mp in (None, mask_pos):
        got, want = ex_port(restypes, chains, mp), ex_jax(restypes, chains, mp)
        assert got.shape == (10, 64)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    for fn in ("build_chain_separated_sequence", "chain_grouped_order", "residue_keep_indices"):
        a, b = (getattr(m, fn)(restypes, chains) if fn == "build_chain_separated_sequence"
                else getattr(m, fn)(chains) for m in (port_esm, jax_esm))
        assert np.array_equal(a, b) if fn != "build_chain_separated_sequence" else a == b
    jax_esm._extractor_cache.clear()


def test_load_precomputed(tmp_path):
    import packppi_tpu.data.esm as jax_esm
    from packppi_torch.data import esm as port_esm

    rng = np.random.default_rng(0)
    np.savez(tmp_path / "k.npz", wt=rng.normal(size=(5, 8)), mut=rng.normal(size=(5, 8)))
    got, want = port_esm.load_precomputed(tmp_path, "k"), jax_esm.load_precomputed(tmp_path, "k")
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
    assert port_esm.load_precomputed(tmp_path, "none") is None


def test_config_defaults_match_jax():
    ours = dataclasses.asdict(ESM2Config())
    theirs = dataclasses.asdict(JaxConfig())
    assert ours == theirs

"""ESM-2 protein language model in PyTorch, with HuggingFace names.

The reference embeds sequences with ESM-2 650M (``facebook/esm2_t33_650M_
UR50D``) for PackPPI-AP's ``esm`` mode. ``ESM2``'s parameter names are
HuggingFace ``EsmModel``'s (``embeddings.word_embeddings.weight``,
``encoder.layer.N.attention.self.query.*``, ...,
``encoder.emb_layer_norm_after.*``), so an HF state dict loads directly
(``weights.load_esm_state_dict``).

Semantics are fair-esm's ESM-2, as in the JAX package: the query scaled by
d_h^-0.5 before rotary; half-split rotary tables built in float64; pre-LN
blocks with LayerNorm eps 1e-5 (two-pass variance, not flax's) and a final
LayerNorm; erf-GELU; token dropout's rescale of mask tokens by the
mask-aware source length, with padding embeddings zeroed. Softmax and
LayerNorm run in float32. ``compute_dtype="bfloat16"`` runs the linear
maps as bf16 products whose outputs are rounded to bf16 (the JAX package
keeps those outputs in float32).

Attention (``attention_impl``): "auto" is the CUDA kernel of
``ops.attention`` on the card, at every length, and its plain version on
the CPU; "flash" is the kernel and raises on the CPU; "dense" is the plain
version.

The fixed 33-token ESM alphabet ships here too (``tokenize``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from packppi_torch.ops.attention import mha, mha_plain

# The fair-esm / HF ESM-2 alphabet (fixed across all ESM-2 checkpoints):
# ids 0-3 are specials, 4-30 residue/extra symbols, 31 <null_1>, 32 <mask>.
ESM_TOKENS = (
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
)
TOKEN_TO_ID = {t: i for i, t in enumerate(ESM_TOKENS)}
CLS_ID, PAD_ID, EOS_ID, UNK_ID, MASK_ID = 0, 1, 2, 3, 32

_SPECIAL_RE = re.compile(r"<[^>]+>|.")


def tokenize(seq: str, add_special_tokens: bool = True) -> np.ndarray:
    """Token ids of a sequence that may embed ``<pad>``/``<mask>`` specials:
    one id per residue character or ``<...>`` special, unknown ones <unk>,
    framed by <cls> and <eos>."""
    ids = [TOKEN_TO_ID.get(tok, UNK_ID) for tok in _SPECIAL_RE.findall(seq)]
    if add_special_tokens:
        ids = [CLS_ID] + ids + [EOS_ID]
    return np.asarray(ids, dtype=np.int32)


ATTENTION_IMPLS = ("auto", "flash", "dense")


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    vocab_size: int = 33
    hidden_size: int = 1280          # 650M
    num_layers: int = 33
    num_heads: int = 20
    intermediate_size: int = 5120
    layer_norm_eps: float = 1e-5     # HF esm2 config value
    token_dropout: bool = True
    mask_token_id: int = MASK_ID
    pad_token_id: int = PAD_ID
    compute_dtype: str = "float32"   # or "bfloat16"
    attention_impl: str = "dense"    # "auto", "flash" or "dense" (module docstring)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def validate(self) -> None:
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"ESM2Config.attention_impl={self.attention_impl!r} "
                             f"(one of {ATTENTION_IMPLS})")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"ESM2Config.compute_dtype={self.compute_dtype!r} "
                             "(float32 or bfloat16)")
        if self.hidden_size % self.num_heads or self.head_dim % 2:
            raise ValueError("hidden_size must split into heads of an even width")


def rope_tables(T: int, head_dim: int, device=None):
    """[T, head_dim] cos and sin of the half-split rotary embedding, built in
    float64 and rounded to float32."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    freqs = np.outer(np.arange(T, dtype=np.float64), inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb), dtype=torch.float32, device=device))


def apply_rope(x, cos, sin):
    """x [B, H, T, D]: x * cos + rotate_half(x) * sin, rotate_half = (-x2, x1)."""
    d = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., d:], x[..., :d]], -1) * sin


class _Embeddings(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            padding_idx=cfg.pad_token_id)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        hid = cfg.hidden_size
        self.query, self.key, self.value = (nn.Linear(hid, hid) for _ in range(3))


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)


class _Attention(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.self = _SelfAttention(cfg)
        self.output = _Dense(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Layer(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: ESM2Config):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))
        self.emb_layer_norm_after = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class ESM2(nn.Module):
    """``forward(input_ids [B, T], attention_mask [B, T] 0/1)`` -> the last
    hidden state [B, T, hidden] float32 after the final LayerNorm
    (``EsmModel(...).last_hidden_state`` with fair-esm's token dropout)."""

    def __init__(self, cfg: ESM2Config = ESM2Config()):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)

    def _ln(self, x, ln: nn.LayerNorm):
        return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)

    def _dot(self, x, lin: nn.Linear):
        if self.cfg.compute_dtype == "float32":
            return F.linear(x.float(), lin.weight, lin.bias)
        bf = torch.bfloat16
        return F.linear(x.to(bf), lin.weight.to(bf)).float() + lin.bias

    def embed(self, input_ids, attention_mask):
        """Token embeddings with the token-dropout rescale and padding zeroed,
        and the additive key bias [B, T] (-1e9 on padded keys)."""
        cfg = self.cfg
        amask = attention_mask.float()
        x = self.embeddings.word_embeddings.weight[input_ids]
        if cfg.token_dropout:
            is_mask = input_ids == cfg.mask_token_id
            x = torch.where(is_mask[..., None], 0.0, x)
            mask_ratio_train = 0.15 * 0.8
            src_len = torch.clamp(amask.sum(-1), min=1.0)
            ratio_obs = is_mask.float().sum(-1) / src_len
            x = x * ((1.0 - mask_ratio_train) / (1.0 - ratio_obs))[:, None, None]
        return x * amask[..., None], (amask - 1.0) * 1e9

    def _attention(self, q, k, v, kbias):
        impl = self.cfg.attention_impl
        if impl == "dense":
            return mha_plain(q, k, v, kbias)
        if impl == "flash" and q.device.type != "cuda":
            raise RuntimeError("attention_impl='flash' runs the CUDA kernel and needs a CUDA "
                               "tensor; use 'auto' or 'dense' on the CPU")
        return mha(q, k, v, kbias)

    def layer_forward(self, layer: _Layer, x, kbias, cos, sin):
        """One pre-LN block."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, D = cfg.num_heads, cfg.head_dim
        cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        att = layer.attention
        ln = self._ln(x, att.LayerNorm)
        to_heads = lambda y: y.reshape(B, T, H, D).transpose(1, 2)
        # ESM scales the query by d_h^-0.5 before rotary
        q = apply_rope(to_heads(self._dot(ln, att.self.query)) * (D ** -0.5), cos, sin)
        k = apply_rope(to_heads(self._dot(ln, att.self.key)), cos, sin)
        v = to_heads(self._dot(ln, att.self.value))
        ctx = self._attention(*(t.to(cd).contiguous() for t in (q, k, v)), kbias)
        x = x + self._dot(ctx.transpose(1, 2).reshape(B, T, H * D), att.output.dense)
        ln = self._ln(x, layer.LayerNorm)
        h = F.gelu(self._dot(ln, layer.intermediate.dense), approximate="none")
        return x + self._dot(h, layer.output.dense)

    def forward(self, input_ids, attention_mask, num_layers: Optional[int] = None):
        """``num_layers`` runs the first N blocks only (then the final
        LayerNorm): a forward cut in depth, for checks."""
        x, kbias = self.embed(input_ids, attention_mask)
        cos, sin = rope_tables(input_ids.shape[1], self.cfg.head_dim, x.device)
        for layer in self.encoder.layer[:num_layers]:
            x = self.layer_forward(layer, x, kbias, cos, sin)
        return self._ln(x, self.encoder.emb_layer_norm_after)


def init_esm_weights(model: ESM2, seed: int, std: float = 0.02) -> None:
    """Random weights from ``seed`` as HuggingFace's ``_init_weights`` draws
    them: normal(0, std) Linear and embedding weights (the padding row
    zeroed), zero biases, LayerNorm at 1 and 0. Drawn on the CPU, so a seed
    gives the same weights whatever device the model is moved to."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.copy_(torch.empty(m.weight.shape).normal_(0.0, std, generator=g))
                if isinstance(m, nn.Embedding) and m.padding_idx is not None:
                    m.weight[m.padding_idx].zero_()
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


def make_extractor(model: ESM2):
    """``extract(ids) -> [len(ids), hidden]`` float32 numpy for one token
    sequence (no cls/eos strip: callers slice). The tokens are padded to a
    multiple of 128 and the padding masked; the model runs where its
    parameters lie."""
    device = next(model.parameters()).device
    cfg = model.cfg

    @torch.inference_mode()
    def extract(ids: np.ndarray) -> np.ndarray:
        n = len(ids)
        T = max(128, -(-n // 128) * 128)
        ids_p = np.full((1, T), cfg.pad_token_id, np.int64)
        ids_p[0, :n] = ids
        mask = np.zeros((1, T), np.float32)
        mask[0, :n] = 1.0
        out = model(torch.from_numpy(ids_p).to(device), torch.from_numpy(mask).to(device))
        return out[0, :n].cpu().numpy()

    return extract

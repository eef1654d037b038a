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
LayerNorm run in float32. In float32 the linear maps go through
``ops.gemm`` (on the card a 3xTF32 tensor-core kernel, whose epilogues add
the bias, the GELU and the residual, and give the query, key and value
scaled, rotated and in the attention's layout from one product;
``F.linear`` elsewhere). ``compute_dtype="bfloat16"`` runs the linear
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

from packppi_torch.ops import gemm
from packppi_torch.ops.attention import mha, mha_plain
from packppi_torch.ops.gemm import apply_rope
from packppi_torch.utils.trace import span

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
        return self._mm(x, lin.weight, lin.bias)

    def _mm(self, x, weight, bias=None, gelu=False, residual=None):
        """``residual + gelu(x . weight^T + bias)`` (gelu and residual
        optional). float32: ``ops.gemm.linear`` (3xTF32 on the card's tensor
        cores, ``F.linear`` elsewhere); bfloat16: a bf16 product rounded to
        bf16, then the bias, the GELU and the residual in float32."""
        if self.cfg.compute_dtype == "float32":
            return gemm.linear(x.float(), weight, bias, gelu=gelu, residual=residual)
        bf = torch.bfloat16
        out = F.linear(x.to(bf), weight.to(bf)).float()
        out = out if bias is None else out + bias
        out = F.gelu(out, approximate="none") if gelu else out
        return out if residual is None else residual + out

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
        return self.block(dict(layer.named_parameters()), x, kbias, cos, sin)

    def block(self, lp: dict, x, kbias, cos, sin, reduce=None):
        """One pre-LN block over the tensors ``lp`` (a ``_Layer``'s names).
        Under tensor parallelism ``lp`` holds a rank's heads and FFN columns
        and ``reduce`` sums the two partial output projections over the
        ranks before their biases are added."""
        cfg = self.cfg
        B, T, _ = x.shape
        D = cfg.head_dim
        H = lp["attention.self.query.weight"].shape[0] // D
        cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

        def ln(y, name):
            return F.layer_norm(y.float(), (cfg.hidden_size,), lp[f"{name}.weight"],
                                lp[f"{name}.bias"], cfg.layer_norm_eps)

        def out_proj(y, name, res):
            """res + y . W^T + b; under tensor parallelism the bias and the
            residual are added after the ranks' partial products are summed."""
            w, b = lp[f"{name}.weight"], lp[f"{name}.bias"]
            if reduce is None:
                return self._mm(y, w, b, residual=res)
            return res + (reduce(self._mm(y, w)) + b)

        h = ln(x, "attention.LayerNorm")
        names = [f"attention.self.{n}" for n in ("query", "key", "value")]
        ws, bs = [lp[f"{n}.weight"] for n in names], [lp[f"{n}.bias"] for n in names]
        # ESM scales the query by d_h^-0.5 before rotary
        if cfg.compute_dtype == "float32":
            q, k, v = gemm.linear_heads(h, ws, bs, cos, sin, D ** -0.5)
        else:
            q, k, v = (self._mm(h, w, b).reshape(B, T, H, D).transpose(1, 2)
                       for w, b in zip(ws, bs))
            q = apply_rope(q * (D ** -0.5), cos, sin)
            k = apply_rope(k, cos, sin)
        ctx = self._attention(*(t.to(cd).contiguous() for t in (q, k, v)), kbias)
        x = out_proj(ctx.transpose(1, 2).reshape(B, T, H * D), "attention.output.dense", x)
        h = self._mm(ln(x, "LayerNorm"), lp["intermediate.dense.weight"],
                     lp["intermediate.dense.bias"], gelu=True)
        return out_proj(h, "output.dense", x)

    def forward(self, input_ids, attention_mask, num_layers: Optional[int] = None):
        """``num_layers`` runs the first N blocks only (then the final
        LayerNorm): a forward cut in depth, for checks."""
        x, kbias = self.embed(input_ids, attention_mask)
        cos, sin = rope_tables(input_ids.shape[1], self.cfg.head_dim, x.device)
        for layer in self.encoder.layer[:num_layers]:
            x = self.layer_forward(layer, x, kbias, cos, sin)
        return self._ln(x, self.encoder.emb_layer_norm_after)


def esm2_tp_shards(model: ESM2) -> dict:
    """``{name: axis or None}``: tensor parallelism over ``model`` as the JAX
    package's ``esm2_param_shardings`` lays it out. q/k/v and FFN-in are
    split on their output axis (axis 0 of a ``[out, in]`` weight, and their
    biases), the attention output and FFN-out on their input axis (axis 1;
    their biases whole); the embedding and LayerNorms replicate."""
    out = {}
    for name, _ in model.named_parameters():
        axis = None
        if ".attention.self." in name or ".intermediate.dense." in name:
            axis = 0
        elif name.endswith("output.dense.weight"):
            axis = 1
        out[name] = axis
    return out


class TensorParallelESM2:
    """ESM-2 under tensor parallelism over ``mesh.model``: each rank holds
    its ``num_heads / model`` heads of q/k/v, its share of the FFN columns
    and the matching input slices of the two output projections, on
    ``device`` (the whole model may stay on the CPU). Each block runs the
    attention kernel on the rank's own heads and ends its two halves with an
    all-reduce over ``model``; rows split over ``data``. ``forward`` gives
    the rank's rows of ``ESM2.forward``, equal up to float32 summation
    order."""

    def __init__(self, model: ESM2, mesh, device):
        cfg = model.cfg
        if cfg.num_heads % mesh.model:
            raise ValueError(f"{cfg.num_heads} heads do not split over model={mesh.model}")
        self.model, self.mesh = model, mesh
        # the embedding and final LayerNorm run whole, from the model
        model.embeddings.to(device)
        model.encoder.emb_layer_norm_after.to(device)
        axes = esm2_tp_shards(model)
        self.tensors = {}
        with torch.no_grad():
            for name, t in model.encoder.layer.named_parameters(prefix="encoder.layer"):
                axis = axes[name]
                piece = t if axis is None else t.chunk(mesh.model, axis)[mesh.model_index]
                self.tensors[name] = piece.detach().to(device).contiguous()

    def _reduce(self, part):
        from packppi_torch.parallel.launch import all_reduce

        return all_reduce(part, self.mesh.model_group)

    @torch.no_grad()
    def forward(self, input_ids, attention_mask):
        """The rank's rows (``parallel.batch_rows``) of the GLOBAL batch's
        ``[B, T]`` ids and mask -> their last hidden states."""
        from packppi_torch.parallel.mesh import batch_rows

        model, t = self.model, self.tensors
        rows = batch_rows(self.mesh, input_ids.shape[0])
        x, kbias = model.embed(input_ids[rows], attention_mask[rows])
        cos, sin = rope_tables(input_ids.shape[1], model.cfg.head_dim, x.device)
        for i in range(model.cfg.num_layers):
            pre = f"encoder.layer.{i}."
            lp = {k[len(pre):]: v for k, v in t.items() if k.startswith(pre)}
            x = model.block(lp, x, kbias, cos, sin, reduce=self._reduce)
        return model._ln(x, model.encoder.emb_layer_norm_after)


def place_pipeline_stage(model: ESM2, mesh, device) -> None:
    """Move what stage ``mesh.model_index`` of ``esm2_pipeline_forward``
    runs to ``device``: the embedding, the final LayerNorm and its
    ``num_layers / model`` blocks (the other blocks stay where they are)."""
    per = model.cfg.num_layers // mesh.model
    s = mesh.model_index
    model.embeddings.to(device)
    model.encoder.emb_layer_norm_after.to(device)
    for layer in model.encoder.layer[s * per:(s + 1) * per]:
        layer.to(device)


@torch.no_grad()
def esm2_pipeline_forward(model: ESM2, input_ids, attention_mask, mesh,
                          n_microbatches: Optional[int] = None):
    """``ESM2.forward`` with the blocks pipelined over ``mesh.model`` stages
    (``parallel.pipeline_apply``, GPipe): ids and mask of the GLOBAL batch
    in, the rank's rows of the last hidden state out. ``n_microbatches``
    defaults to the rows of a data shard, as in the JAX package."""
    from packppi_torch.parallel.pipeline import pipeline_apply

    x, kbias = model.embed(input_ids, attention_mask)
    cos, sin = rope_tables(input_ids.shape[1], model.cfg.head_dim, x.device)

    def apply_layer(layer, carry):
        x, kbias = carry
        return model.layer_forward(layer, x, kbias, cos, sin), kbias

    if n_microbatches is None:
        n_microbatches = max(1, x.shape[0] // mesh.data)
    x, _ = pipeline_apply(mesh, list(model.encoder.layer), (x, kbias), apply_layer,
                          n_microbatches)
    return model._ln(x, model.encoder.emb_layer_norm_after)


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


def pad_tokens(seqs, pad_id: int = PAD_ID):
    """Token sequences -> ``(ids [B, T] int64, mask [B, T] float32)`` numpy:
    every row padded with ``pad_id`` to one ``T``, the longest sequence
    rounded up to a multiple of 128, and each row's padding masked."""
    n = max(len(s) for s in seqs)
    T = max(128, -(-n // 128) * 128)
    ids = np.full((len(seqs), T), pad_id, np.int64)
    mask = np.zeros((len(seqs), T), np.float32)
    for b, s in enumerate(seqs):
        ids[b, :len(s)] = s
        mask[b, :len(s)] = 1.0
    return ids, mask


def embed_rows(model: ESM2, input_ids, attention_mask, rows):
    """One forward over ``[B, T]`` tokens, read at ``rows``: indices into
    the forward's ``B * T`` positions, where ``B * T`` names a row of zeros
    (padding). Returns ``rows.shape + (hidden,)`` on the model's device."""
    with span("esm.embed"):
        out = model(input_ids, attention_mask)
        flat = out.reshape(-1, out.shape[-1])
        return torch.cat([flat, flat.new_zeros(1, flat.shape[-1])])[rows]


def make_extractor(model: ESM2):
    """``extract(seqs)`` -> one float32 numpy array ``[len(seqs[b]), hidden]``
    for each token sequence ``seqs[b]`` (cls and eos included), from one
    forward over all of them (``pad_tokens``). The model runs where its
    parameters lie."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def extract(seqs):
        ids, mask = pad_tokens(seqs, model.cfg.pad_token_id)
        out = model(*(torch.from_numpy(a).to(device) for a in (ids, mask))).cpu().numpy()
        return [o[:len(s)] for o, s in zip(out, seqs)]

    return extract

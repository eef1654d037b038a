"""ESM-2 (Lin et al., Science 379:1123, 2023; fair-esm's ``ESM2``) and
PackPPI-AP's esm-mode head, in plain float32 PyTorch.

The sequence: the complex's residues chain by chain, the chains in sorted
index order and joined by 20 ``<pad>`` tokens, framed by ``<cls>`` and
``<eos>`` (the PackPPI reference's ``get_esm_feature``). The forward, as
fair-esm computes it: the token embedding with token dropout's rescale
(mask tokens zeroed, every row times 0.88 over one less the share of mask
tokens) and padding zeroed; in each of the pre-LN blocks the query scaled by
d^-0.5 before rotary, half-split rotary embeddings from float64 tables,
plain softmax attention, the output projection, then LayerNorm, a 4x FFN
with erf-GELU; a final LayerNorm. LayerNorm is torch's (eps 1e-5, the
variance of the centred values). The residue embeddings are the final
LayerNorm's rows at the residues' tokens. The head: the largest of (mutant
- wild type) over every row, padding rows included, through three linear
maps with ReLU between; its twin reads (wild type - mutant).

Departures from fair-esm and the PackPPI reference, each the program's:
- a residue whose backbone is incomplete (no N, CA, C or O) has its chain
  index zeroed, so it forms a chain of its own, first; in the wild type
  its residue type is zeroed too (alanine), while the mutant keeps its
  type. The pads between chains are dropped, so row i is residue i (the
  reference keeps the tokens after ``<cls>`` in order, which misaligns every
  chain after the first).
- each sequence runs alone at its own length, so nothing is padded or
  masked; the head's rows are padded with zeros to the batch's longest
  mutation.
- no contact head and no language-model head.

Every product goes through one ``quant`` (``None``: float32) that rounds
both operands, for the control (``precision.py``). TF32 is off for the
products that are not rounded on purpose.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import chem

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# fair-esm's ESM-2 alphabet
ALPHABET = ("<cls>", "<pad>", "<eos>", "<unk>", "L", "A", "G", "V", "S", "E", "R", "T", "I",
            "D", "P", "K", "Q", "N", "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".",
            "-", "<null_1>", "<mask>")
CLS, PAD, EOS, MASK = 0, 1, 2, 32
PAD_RUN = 20
LN_EPS = 1e-5


def mutant_types(parsed: dict, mutations: list) -> np.ndarray:
    """The residue types with ``mutations`` (``affinity.parse_mutation``'s
    dicts) applied, each checked against the structure's wild type."""
    aatype = parsed["aatype"].copy()
    for m in mutations:
        sel = (parsed["chain"] == m["chain"]) & (parsed["resseq"] == m["resseq"])
        if not sel.any() or chem.RESTYPES[int(parsed["aatype"][sel][0])] != m["wt"]:
            raise ValueError(f"mutation {m} does not match the structure")
        aatype[sel] = chem.RESTYPES.index(m["mt"])
    return aatype


def tokens(aatype: np.ndarray, chain: np.ndarray):
    """``(ids, rows)``: the token ids of the sequence and the index of each
    residue's token in them."""
    ids, rows = [CLS], np.zeros(len(aatype), np.int64)
    chains = sorted(set(chain.tolist()))
    for j, c in enumerate(chains):
        for i in np.flatnonzero(chain == c):
            rows[i] = len(ids)
            ids.append(ALPHABET.index(chem.RESTYPES[int(aatype[i])]))
        if j < len(chains) - 1:
            ids.extend([PAD] * PAD_RUN)
    ids.append(EOS)
    return np.array(ids, np.int64), rows


class Params:
    """The HuggingFace-named ESM-2 tensors and the rounding applied to
    products."""

    def __init__(self, state: dict, quant=None):
        self.state, self.quant = state, quant

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.quant is not None:
            a, b = self.quant(a), self.quant(b)
        return a @ b

    def lin(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x, self.state[f"{prefix}.weight"].t()) + self.state[f"{prefix}.bias"]

    def ln(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + LN_EPS) * self.state[f"{prefix}.weight"]
                + self.state[f"{prefix}.bias"])


def rotary(n: int, d: int, device):
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float64) / d))
    freqs = np.outer(np.arange(n, dtype=np.float64), inv)
    emb = np.concatenate([freqs, freqs], -1)
    return (torch.tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb), dtype=torch.float32, device=device))


def rotate(x, cos, sin):
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], -1) * sin


def forward(p: Params, ids: torch.Tensor, heads: int, layers: int) -> torch.Tensor:
    """One sequence's token ids [n] -> the final LayerNorm's output [n, hidden]."""
    x = p.state["embeddings.word_embeddings.weight"][ids]
    is_mask = ids == MASK
    x = torch.where(is_mask[:, None], torch.zeros_like(x), x)
    x = x * (1.0 - 0.15 * 0.8) / (1.0 - is_mask.float().mean())
    n, hidden = x.shape
    d = hidden // heads
    cos, sin = rotary(n, d, x.device)
    split = lambda y: y.view(n, heads, d).transpose(0, 1)            # [heads, n, d]
    for i in range(layers):
        pre = f"encoder.layer.{i}."
        h = p.ln(pre + "attention.LayerNorm", x)
        q = rotate(split(p.lin(pre + "attention.self.query", h)) * d ** -0.5, cos, sin)
        k = rotate(split(p.lin(pre + "attention.self.key", h)), cos, sin)
        v = split(p.lin(pre + "attention.self.value", h))
        att = torch.softmax(p.mm(q, k.transpose(-1, -2)), -1)
        ctx = p.mm(att, v).transpose(0, 1).reshape(n, hidden)
        x = x + p.lin(pre + "attention.output.dense", ctx)
        h = F.gelu(p.lin(pre + "intermediate.dense", p.ln(pre + "LayerNorm", x)))
        x = x + p.lin(pre + "output.dense", h)
    return p.ln("encoder.emb_layer_norm_after", x)


def head(p: Params, wt: torch.Tensor, mt: torch.Tensor):
    """(ddg [B], ddg_inv [B]) over residue rows [B, L, hidden], zeros at
    padding; ``p`` holds ``ddg_predictor.{0,2,4}``."""
    def mlp(x):
        x = F.relu(p.lin("ddg_predictor.0", x))
        return p.lin("ddg_predictor.4", F.relu(p.lin("ddg_predictor.2", x)))[..., 0]

    return mlp((mt - wt).amax(1)), mlp((wt - mt).amax(1))

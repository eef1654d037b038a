"""PackPPI in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The side-chain packing, clash-refinement, diffusion-training and ddG paths
of ``packppi_tpu`` rebuilt on PyTorch: parse and featurize a structure,
build the kNN graph once, run the 30-step SO(2) ODE sampler over
``ChiScoreNetwork``, refine the chis with the 50-step proximal clash
optimizer, and rebuild atom14 coordinates; train the network by SO(2) score
matching (``cli.train_diffusion``); predict the ddG of mutations from the
frozen network's features or ESM-2 650M embeddings (``cli.ddg``). The hot
steps run as CUDA kernels from ``csrc/`` on the card and as their plain
PyTorch versions on CPU tensors: in every IPMP layer the message MLP, with
the point geometry computed in the kernel (``ops.message``) or taken as
features (``ops.message_feat``, differentiable), and the residual ->
LayerNorm -> FFN -> LayerNorm chain (``ops.chain``, differentiable); in
every optimizer step of the refinement the between-residue clash sums and
their gradient (``ops.clash``); in every ESM-2 block the attention
(``ops.attention``).

This package imports neither JAX nor ``packppi_tpu``.
"""
import torch

# float32 products stay float32 on the card: TF32 keeps ~3 decimal digits,
# which would round O(100 A) coordinates and break parity with the reference
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

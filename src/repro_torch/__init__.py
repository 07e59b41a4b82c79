"""repro_torch — MILO on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that mirrors its layout and names.  It
imports ``torch`` and numpy only: nothing of JAX and nothing of ``repro``
(the tests import both to hold one against the other).

Covered so far: the paper's Algorithm 1 on the flat, dense, by-class path —
``MiloSession.preprocess`` (rescaled-cosine Gram → stochastic-greedy graph-cut
SGE bank → full-greedy disparity-min WRE importance → ``MiloMetadata``) and
``MiloSession.train`` (curriculum plans → MLP training on the step loop or,
with ``fused_training=True``, on the fused engine as CUDA graphs), and
``MiloSession.tune`` (TPE / random search × Hyperband, ``milo_fixed``,
``adopt_metadata``).  The Gram
tiles go through a hand-written CUDA kernel (``kernels/similarity``) when
``use_pallas=True``.  Also the gram-free route (``gram_free=True``: the set
functions contract features, no Gram) with facility-location importance
under lazy gains (``lazy_gains=True``), whose gains and lazy corrections go
through the hand-written ``fl_gains`` kernels (``kernels/fl_gains``).  And the
LM serving path: ``serve.lm_engine.ServeEngine`` over ``models.lm`` (dense,
MoE and Mamba blocks), whose prefill runs the hand-written flash-attention
(``kernels/flash_attention``) and SSD chunk (``kernels/ssd_chunk``) kernels
with ``attention_impl="pallas"`` and ``ssm_impl="pallas"``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a card they raise instead of carrying on elsewhere.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

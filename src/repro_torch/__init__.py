"""PyTorch/CUDA port of ``repro``: structured nonlinear embeddings
f(A·D1·H·D0·x), the paged serving path (full-KV or SRF attention) and
the training path (loss, AdamW, checkpointed trainer), for one NVIDIA
H100.

Layout mirrors ``src/repro`` (``repro_torch/core/spinner.py`` ↔
``repro/core/spinner.py`` and so on). The package imports torch and
never jax, and nothing of ``repro``: the jax-free modules it needs
(configs, the scheduler, the metrics registry) are copies.

Numerics: TF32 is switched off for matmuls and cuDNN here, once, at
package import, so a float32 product on the card is a float32 product
(the reference computes in full f32). bf16 configs are unaffected.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

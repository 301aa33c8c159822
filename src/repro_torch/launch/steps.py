"""Step factories: port of ``repro.launch.steps`` (``TrainHyper``,
``make_train_step``, ``make_grad_step``, ``make_prefill_step``,
``make_serve_step``, ``make_encode_step``, ``make_paged_step``). Each
step is one eager function. A training step: forward and loss,
``torch.autograd.grad`` over the float params, the schedule, AdamW. The
serve steps drive the legacy engine's per-slot cache.

The reference's ``_prewarm_srf_spinner`` has no counterpart: it pins
the Pallas spinner's block-size plan at factory time, and the port's
CUDA kernels have no plan cache (their block sizes are their own) and
build at their first launch."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.models import transformer as model
from repro_torch.optim import adamw, schedule


@dataclass(frozen=True)
class TrainHyper:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    adam: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    aux_weight: float = 0.01


def _grads(params, loss: torch.Tensor):
    """d loss / d params for every param that requires grad; None for
    the others (the integer seeds of seeded SRF)."""
    leaves = [p for p in tree_lib.leaves(params) if p.requires_grad]
    got = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return tree_lib.map(lambda p: got.get(id(p)), params)


def _detached(metrics: Dict) -> Dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_grad_step(cfg, aux_weight: float = 0.01):
    """(params, batch) -> (grads, {"loss", "xent", "aux"}): gradients
    only (for a trainer that reduces them before the optimizer)."""
    def grad_step(params, batch) -> Tuple[Dict, Dict]:
        loss, metrics = model.loss_fn(params, cfg, batch, aux_weight)
        return _grads(params, loss), {"loss": loss.detach(),
                                      **_detached(metrics)}
    return grad_step


def make_train_step(cfg, hyper: TrainHyper = TrainHyper()):
    """(params, opt_state, step_idx, batch) -> (params, opt_state,
    {"loss", "lr", "xent", "aux", "grad_norm"}), params and moments
    updated in place (``adamw.update``). Metrics are 0-d tensors on the
    params' device: reading one syncs the host."""
    grad_step = make_grad_step(cfg, hyper.aux_weight)

    def train_step(params, opt_state, step_idx, batch):
        grads, metrics = grad_step(params, batch)
        lr = schedule.warmup_cosine(step_idx, hyper.lr, hyper.warmup,
                                    hyper.total_steps,
                                    device=metrics["loss"].device)
        params, opt_state, stats = adamw.update(grads, opt_state, params,
                                                lr, hyper.adam)
        return params, opt_state, {"loss": metrics["loss"], "lr": lr,
                                   **metrics, **stats}
    return train_step


def make_prefill_step(cfg):
    """(params, batch, cache) -> (logits of the last position (B, 1,
    V_padded), cache): ``transformer.prefill``."""
    def prefill_step(params, batch, cache):
        return model.prefill(params, cfg, batch, cache)
    return prefill_step


def make_encode_step(cfg):
    """Enc-dec encoder pass: (params, enc_emb (B, E, feat)) -> memory
    (B, E, d_model), ``transformer.encode_memory``. The paged engine
    runs it once a request at admission (batch 1, the legacy engine's
    prefill computation) into the read-only memory pool."""
    def encode_step(params, enc_emb):
        return model.encode_memory(params, cfg, enc_emb)
    return encode_step


def make_paged_step(cfg, mesh=None, paged=None, params_sds=None):
    """Batched paged serving step (decode: C = 1; chunked prefill: C =
    chunk): (params, pools, tokens (B, C), positions (B, C), q_valid
    (B, C), tables (B, M), slots (B,), embed_seeds=None) -> (logits (B,
    C, V_padded), pools), ``transformer.paged_step``; the pools are
    updated in place. ``embed_seeds`` (B,): seeded SRF's per-request
    projection seeds.

    ``mesh``: mesh-sharded serving. When the family's head counts divide
    the mesh's model axis (``serving.mesh.shard.paged_tp``), the step
    takes the ``ShardedTree`` s of ``shard.place_params`` and
    ``paged_cache.init_pools(mesh=)``: q/k/v column-parallel, pools the
    local head blocks, the body under the shard-local config with the
    model axis as ``tp_axis`` (attention stitches the head outputs
    before the replicated wo, so greedy tokens equal the unsharded
    engine's). Families that degrade to replication (MLA latents, SSD,
    indivisible heads) run the plain body on the mesh's home device.
    ``paged`` (its int8 scale leaves) and ``params_sds`` (any tree of
    the params' shapes) give the layouts the step checks its inputs
    against at its first call."""
    def plain(params, pools, tokens, positions, q_valid, tables, slots,
              embed_seeds=None):
        return model.paged_step(params, cfg, pools, tokens, positions,
                                q_valid, tables, slots,
                                embed_seeds=embed_seeds)
    if mesh is None:
        return plain
    from repro_torch.distributed import collectives
    from repro_torch.serving.mesh import shard as mesh_shard
    tp = mesh_shard.paged_tp(cfg, mesh)
    if tp <= 1:
        return plain                    # replication degradation
    cfg_local = mesh_shard.local_cfg(cfg, tp)
    axis = collectives.axis_of(mesh, "model")
    want = {"pools": mesh_shard.pool_specs(cfg, mesh, paged)}
    if params_sds is not None:
        want["params"] = mesh_shard.serving_param_specs(params_sds, cfg,
                                                        mesh)
    checked = []

    def sharded(params, pools, tokens, positions, q_valid, tables, slots,
                embed_seeds=None):
        if not checked:
            got = {"pools": pools.specs, "params": params.specs}
            for k, spec in want.items():
                if tree_lib.leaves(spec) != tree_lib.leaves(got[k]):
                    raise ValueError(f"the {k} are not laid out for this "
                                     f"mesh step")
            checked.append(True)
        logits, _ = model.paged_step(params.parts, cfg_local, pools.parts,
                                     tokens, positions, q_valid, tables,
                                     slots, embed_seeds=embed_seeds,
                                     tp_axis=axis)
        return logits, pools
    return sharded


def make_serve_step(cfg, greedy: bool = True, temperature: float = 1.0):
    """One decode step: (params, cache, tokens (B, 1)) -> (greedy next
    tokens (B, 1), logits (B, vocab) of the new position, cache). The
    next tokens are the argmax whatever ``greedy`` and ``temperature``
    say, as in the reference (a caller samples from the logits)."""
    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cfg, cache, tokens)
        logits = logits[:, -1, : cfg.vocab]
        return torch.argmax(logits, dim=-1)[:, None], logits, cache
    return serve_step

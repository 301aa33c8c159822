"""Mamba-2 (SSD, state-space duality) block: the chunked scan form.

Port of ``repro.models.ssm``: scalar-per-head decay A, per-step dt,
shared B/C (one group), a depthwise causal conv on (x, B, C), a gated
RMSNorm and the out projection. Train and prefill run the
chunk-parallel scan (``_chunk_scan``: O(L c) a head with chunk c; under
autograd each chunk's body is checkpointed, as the reference's
``jax.checkpoint(step)``); decode is one recurrent state update. The
decode state (B, nh, state, hd) does not grow with the sequence: the
same O(1)-in-L serving story as SRF attention. Plain PyTorch ops, as
the reference's are jnp ops: no TPU kernel computes the scan.

Like the port's attention, every cached path writes its state IN PLACE
and the functions return the block's output alone: ``ssm_apply`` in
modes "prefill" and "decode" into the cache of ``init_ssm_cache``
(``{"conv": (B, k-1, cd)`` in the model dtype, ``"ssm": (B, nh, ns,
hd)`` in f32, ``"idx"``: a host int}), and ``paged_ssm_step`` into the
rows ``slots`` of the engine's slot pool.

``paged_ssm_step`` runs the C tokens of a serving step from the carried
state. The reference scans them one token at a time (``lax.scan``);
eager PyTorch would pay C x ~8 launches a layer for that, so the port
runs the chunk through ``_chunk_scan`` from the carried state (one chunk
of C). Invalid tail tokens get dt = 0, which makes them exact identities
for the state. At C = 1 (a decode step) it runs the token recurrence
(``_token_scan``, also ``_ssm_decode``'s), the cheaper of the two forms
for one token (``launch/time_kernels.py --kernels ssd_scan`` times
both).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from . import layers


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def ssm_init(gen: torch.Generator, cfg, dtype, device=None,
             lead=()) -> Dict:
    """SSD block params (the reference's laws; other numbers), split by
    role (z / x / BC / dt); ``lead`` stacks a leading layer axis."""
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads

    def const(v: torch.Tensor) -> torch.Tensor:    # one copy per layer
        return v.to(dtype).to(device).repeat(*lead, 1)

    def normal(*shape) -> torch.Tensor:
        return (torch.randn((*lead, *shape), generator=gen, device=device)
                * 0.1).to(dtype)
    return {
        "wz": layers.dense_init(gen, d, di, dtype, device, lead=lead),
        "wx": layers.dense_init(gen, d, di, dtype, device, lead=lead),
        "wbc": layers.dense_init(gen, d, 2 * ns, dtype, device, lead=lead),
        "wdt": layers.dense_init(gen, d, nh, dtype, device, lead=lead),
        "conv_x": normal(cfg.ssm_conv, di),
        "conv_bc": normal(cfg.ssm_conv, 2 * ns),
        "conv_b": const(torch.zeros(di + 2 * ns)),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, nh))),
        "d_skip": const(torch.ones(nh)),
        "dt_bias": const(torch.zeros(nh)),
        "norm_w": const(torch.ones(di)),
        "out_proj": layers.dense_init(gen, di, d, dtype, device, lead=lead),
    }


def init_ssm_cache(cfg, batch: int, dtype, device=None, lead=()) -> Dict:
    """The prefill / decode cache of ``batch`` requests: the conv tail in
    the model dtype, the state in f32, zero-filled; ``lead`` stacks a
    leading layer axis."""
    return {"conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1,
                                 conv_dim(cfg)), dtype=dtype, device=device),
            "ssm": torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_state,
                                cfg.ssm_head_dim), dtype=torch.float32,
                               device=device),
            "idx": 0}


def _project(p, x: torch.Tensor):
    """-> z (di), xbc_raw (di + 2 ns), dt_raw (nh)."""
    z = x @ p["wz"]
    xbc = torch.cat([x @ p["wx"], x @ p["wbc"]], dim=-1)
    return z, xbc, x @ p["wdt"]


def _conv_w(p) -> torch.Tensor:
    return torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv as k static shifts. x: (B, L, C), w: (k, C);
    ``tail`` (B, k-1, C): the inputs before x (zeros when None)."""
    k, l = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0)) if tail is None else \
        torch.cat([tail.to(x.dtype), x], dim=1)
    return sum(pad[:, i:i + l] * w[i] for i in range(k)) + b


def _split_xbc(cfg, xbc: torch.Tensor):
    di, ns = cfg.d_inner, cfg.ssm_state
    return torch.split(xbc, [di, ns, ns], dim=-1)


def _dt(p, dt_raw: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt_raw.float() + p["dt_bias"].float())


def _decay_rate(p) -> torch.Tensor:
    return -torch.exp(p["a_log"].float())              # (nh,) negative


def _chunk_body(state: torch.Tensor, xc: torch.Tensor, bc: torch.Tensor,
                cc: torch.Tensor, dtac: torch.Tensor, dtc: torch.Tensor,
                tri: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the scan from ``state``: the chunk's slices of xs,
    bs, cs, dt * a and dt (``_chunk_scan``'s shapes with L = c) and the
    (c, c) lower-triangle mask -> (y (B, c, nh, hd) f32, state')."""
    cum = torch.cumsum(dtac, dim=1)                       # (B, c, nh) <= 0
    # intra-chunk: G[b,i,j,h] = (C_i.B_j) exp(cum_i - cum_j) dt_j, j <= i
    scores = torch.einsum("bis,bjs->bij", cc, bc)
    diff = cum[:, :, None, :] - cum[:, None, :, :]        # (B, c, c, nh)
    # min(diff, 0) before exp: the masked (j > i) region has diff > 0 and
    # would overflow; the kept region has diff <= 0, unchanged. Its
    # gradient splits ties (diff = 0: the diagonal) half and half, as
    # the reference's jnp.minimum does, so the two backwards round alike
    gate = torch.where(tri[None, :, :, None],
                       torch.exp(torch.minimum(diff, diff.new_zeros(()))),
                       0.0)
    g = (scores[..., None] * gate * dtc[:, None, :, :]).to(xc.dtype)
    y = torch.einsum("bijh,bjhd->bihd", g, xc).float()
    # inter-chunk: y_i += C_i . (exp(cum_i) S)
    y = y + torch.einsum("bis,bhsd->bihd", cc.float(), state) \
        * torch.exp(cum)[..., None]
    # S' = exp(cum_T) S + sum_j exp(cum_T - cum_j) dt_j B_j (x) x_j
    tot = cum[:, -1]                                      # (B, nh)
    w = torch.exp(tot[:, None, :] - cum) * dtc            # (B, c, nh)
    state = torch.exp(tot)[:, :, None, None] * state + torch.einsum(
        "bjs,bjhd->bhsd", bc.float(), xc.float() * w[..., None])
    return y, state


def _chunk_scan(xs: torch.Tensor, bs: torch.Tensor, cs: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, state: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk-parallel SSD scan from ``state``.

    xs (B, L, nh, hd), bs and cs (B, L, ns) in the activation dtype; dt
    (B, L, nh) f32; a (nh,) f32; state (B, nh, ns, hd) f32. Returns (y
    (B, L, nh, hd) f32 without the D skip, final state). The derived
    tensors are zero-padded to a chunk multiple: dt = 0 makes a padded
    step an exact identity for the state, and padded outputs are cut.
    The (B, c, c, nh) gate is masked and exponentiated in f32 and
    contracted in the activation dtype, as the reference does.

    Under autograd (grad enabled and an input that requires grad) each
    chunk's body runs under a non-reentrant ``torch.utils.checkpoint``,
    as the reference's scan runs ``jax.checkpoint(step)``: the backward
    recomputes a chunk's (B, c, c, nh) gate and (B, c, c) scores one
    chunk at a time instead of keeping every chunk's alive. Without
    autograd (serving) the body runs plainly; the values are the same."""
    b, l = xs.shape[:2]
    c = min(chunk, l)
    pad = -l % c
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        bs, cs, dt = (F.pad(t, (0, 0, 0, pad)) for t in (bs, cs, dt))
    dta = dt * a
    tri = torch.ones((c, c), dtype=torch.bool, device=xs.device).tril()
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xs, bs, cs, dt, a, state))
    ys = []
    for i in range(0, l + pad, c):
        args = (state, xs[:, i:i + c], bs[:, i:i + c], cs[:, i:i + c],
                dta[:, i:i + c], dt[:, i:i + c], tri)
        y, state = ckpt.checkpoint(_chunk_body, *args, use_reentrant=False,
                                   preserve_rng_state=False) \
            if remat else _chunk_body(*args)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :l], state


def _token_scan(xs: torch.Tensor, bs: torch.Tensor, cs: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, state: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's serving recurrence, one token at a time (shapes as
    ``_chunk_scan``)."""
    ys = []
    for t in range(xs.shape[1]):
        dt_t = dt[:, t]
        state = state * torch.exp(dt_t * a)[:, :, None, None] + \
            torch.einsum("bh,bs,bhd->bhsd", dt_t, bs[:, t].float(),
                         xs[:, t].float())
        ys.append(torch.einsum("bs,bhsd->bhd", cs[:, t].float(), state))
    return torch.stack(ys, dim=1), state


def _out(p, cfg, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
         dtype) -> torch.Tensor:
    """D skip, gated RMSNorm and the out projection: y (B, L, nh, hd) f32
    -> (B, L, d)."""
    b, l = y.shape[:2]
    y = y + p["d_skip"].float()[None, None, :, None] * xs.float()
    y = y.reshape(b, l, cfg.d_inner).to(dtype)
    y = layers.rmsnorm({"w": p["norm_w"]}, y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"]


def ssm_apply(p, cfg, x: torch.Tensor, mode: str,
              cache: Optional[Dict] = None) -> torch.Tensor:
    """(B, L, d) -> (B, L, d). Mode "train": the chunked scan from a zero
    state; "prefill": the same, and ``cache`` takes the final state and
    the last k-1 raw (pre-conv) inputs; "decode": one token against
    ``cache``. The cache is written in place and its "idx" advanced."""
    if mode == "decode":
        return _ssm_decode(p, cfg, x, cache)
    if mode not in ("train", "prefill"):
        raise ValueError(f"ssm mode {mode!r}")
    b, l, _ = x.shape
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc_raw, dt = _project(p, x)
    xbc = F.silu(_causal_conv(_conv_w(p), p["conv_b"], xbc_raw))
    xs, bs, cs = _split_xbc(cfg, xbc)
    xs = xs.reshape(b, l, nh, hd)
    s0 = torch.zeros((b, nh, cfg.ssm_state, hd), dtype=torch.float32,
                     device=x.device)
    y, s_fin = _chunk_scan(xs, bs, cs, _dt(p, dt), _decay_rate(p), s0,
                           cfg.ssm_chunk)
    out = _out(p, cfg, y, xs, z, x.dtype)
    if mode == "prefill":
        # the last k-1 raw (pre-conv) inputs feed the decode conv
        k1 = cfg.ssm_conv - 1
        tail = F.pad(xbc_raw, (0, 0, k1, 0))[:, l:l + k1]
        cache["conv"].copy_(tail)
        cache["ssm"].copy_(s_fin)
        cache["idx"] = l
    return out


def _ssm_decode(p, cfg, x: torch.Tensor, cache: Dict) -> torch.Tensor:
    """One token a request: x (B, 1, d), ``cache`` advanced in place."""
    b = x.shape[0]
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc_new, dt = _project(p, x)
    window = torch.cat([cache["conv"], xbc_new], dim=1)    # (B, k, cd)
    xbc = torch.einsum("bkc,kc->bc", window, _conv_w(p)) + p["conv_b"]
    xs, bs, cs = _split_xbc(cfg, F.silu(xbc)[:, None, :])
    xs = xs.reshape(b, 1, nh, hd)
    y, s = _token_scan(xs, bs, cs, _dt(p, dt), _decay_rate(p), cache["ssm"])
    out = _out(p, cfg, y, xs, z, x.dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(s)
    cache["idx"] += 1
    return out


def paged_ssm_step(p, cfg, x: torch.Tensor, q_valid: torch.Tensor,
                   pool: Dict, slots: torch.Tensor) -> torch.Tensor:
    """Paged serving step: C tokens a request against a carried state.

    x: (B, C, d); q_valid: (B, C) bool (a dense prefix: padding only at
    the chunk's tail); pool: {"conv": (S, k-1, cd), "ssm": (S, nh, ns,
    hd)}; slots: (B,) slot ids. Covers chunked prefill (C = chunk) and
    decode (C = 1). Invalid steps get dt = 0, an exact identity for the
    state, and the conv tail is re-gathered from the last valid inputs,
    so tail padding never leaks into the next chunk. The rows ``slots``
    of ``pool`` are written in place."""
    b, c, _ = x.shape
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    k1 = cfg.ssm_conv - 1
    conv_st = pool["conv"][slots]                          # (B, k-1, cd)
    ssm_st = pool["ssm"][slots]                            # (B, nh, ns, hd)
    z, xbc_raw, dt = _project(p, x)
    xbc_raw = xbc_raw * q_valid[..., None].to(xbc_raw.dtype)
    conv = _causal_conv(_conv_w(p), p["conv_b"], xbc_raw, tail=conv_st)
    xs, bs, cs = _split_xbc(cfg, F.silu(conv))
    xs = xs.reshape(b, c, nh, hd)
    dt = _dt(p, dt) * q_valid.float()[..., None]           # identity on pads
    a = _decay_rate(p)
    y, s_fin = (_token_scan(xs, bs, cs, dt, a, ssm_st) if c == 1
                else _chunk_scan(xs, bs, cs, dt, a, ssm_st, c))
    out = _out(p, cfg, y, xs, z, x.dtype)
    # conv tail = the last k-1 inputs ending at the final valid token
    full = torch.cat([conv_st.to(xbc_raw.dtype), xbc_raw], dim=1)
    n_valid = q_valid.sum(dim=1)                           # (B,)
    idx = n_valid[:, None] + torch.arange(k1, device=x.device)[None, :]
    tail = torch.gather(full, 1, idx[..., None].expand(-1, -1,
                                                       full.shape[-1]))
    pool["conv"][slots] = tail.to(pool["conv"].dtype)
    pool["ssm"][slots] = s_fin
    return out

"""Plain reference of a dense decoder LM of the Qwen3 kind (RMSNorm,
GQA with per-head q/k RMSNorm and half-split RoPE, SwiGLU, the head
tied to the embedding or a leaf of its own),
with full softmax attention or the paper's SRF attention (circulant
spinner features, causal linear attention); and the weights both sides
are handed.

Plain PyTorch in float32 with TF32 off, layer by layer: it imports
neither ``jax`` nor ``repro`` nor ``repro_torch``, and works out again
whatever the port derives from the weights (the SRF projection from its
generator and diagonals). ``quant="fp8"`` is the control: every matmul
operand rounded to float8 e4m3 with one scale a tensor.

The weights are the benchmark's, made here from the seed in the port's
layout (``make_weights``); every leaf draws from a generator of its own,
so one leaf can be made again alone (``make_leaf``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0            # largest float8 e4m3fn value
LINEAR_CHUNK = 512         # keys a block of causal linear attention


# -- sizes --------------------------------------------------------------------

def sizes(config: Dict) -> Dict:
    """The sizes the reference needs, from a configuration file's keys."""
    port = config.get("port", {})
    srf = port.get("srf", {})
    d, v = config["hidden_size"], config["vocab_size"]
    return {"d": d, "layers": config["num_hidden_layers"],
            "hq": config["num_attention_heads"],
            "hkv": config["num_key_value_heads"],
            "hd": config["head_dim"], "ff": config["intermediate_size"],
            "vocab": v, "vocab_padded": -(-v // 256) * 256,
            "tied": bool(config.get("tie_word_embeddings", False)),
            "theta": float(config["rope_theta"]),
            "eps": float(config["rms_norm_eps"]),
            "attn": port.get("attn_impl", "full"),
            "m": srf.get("n_features", 256),
            "kind": srf.get("kind", "circulant"),
            "feature": srf.get("feature", "softmax_pos"),
            "srf_chunk": srf.get("chunk", 128),
            "dtype": getattr(torch, config["torch_dtype"])}


# -- weights ------------------------------------------------------------------

def leaf_specs(s: Dict) -> List[Tuple[tuple, tuple, str, float]]:
    """(path in the port's param tree, shape, law, scale) of every leaf,
    in a fixed order; laws: ``normal`` N(0, scale^2), ``norm`` 1 + N(0,
    scale^2), ``sign`` +-1."""
    L, d, hq, hkv, hd, ff = (s[k] for k in ("layers", "d", "hq", "hkv", "hd",
                                            "ff"))
    vp = s["vocab_padded"]
    seg = ("segments", 0)
    out = [(("embed", "tok"), (vp, d), "normal", 0.02),
           (seg + ("ln1", "w"), (L, d), "norm", 0.1),
           (seg + ("attn", "wq"), (L, d, hq * hd), "normal", d ** -0.5),
           (seg + ("attn", "wk"), (L, d, hkv * hd), "normal", d ** -0.5),
           (seg + ("attn", "wv"), (L, d, hkv * hd), "normal", d ** -0.5),
           (seg + ("attn", "wo"), (L, hq * hd, d), "normal",
            (hq * hd) ** -0.5),
           (seg + ("attn", "q_norm"), (L, hd), "norm", 0.1),
           (seg + ("attn", "k_norm"), (L, hd), "norm", 0.1)]
    if s["attn"] == "srf":
        nb = -(-s["m"] // hd)
        out += [(seg + ("attn", "srf", 0, "g"), (L, hkv, nb, hd), "normal",
                 1.0),
                (seg + ("attn", "srf", 0, "d0"), (L, hkv, hd), "sign", 1.0),
                (seg + ("attn", "srf", 0, "d1"), (L, hkv, hd), "sign", 1.0)]
    out += [(seg + ("ln2", "w"), (L, d), "norm", 0.1),
            (seg + ("mlp", "wi"), (L, d, ff), "normal", d ** -0.5),
            (seg + ("mlp", "wg"), (L, d, ff), "normal", d ** -0.5),
            (seg + ("mlp", "wo"), (L, ff, d), "normal", ff ** -0.5),
            (("final_norm", "w"), (d,), "norm", 0.1)]
    if not s["tied"]:
        out.append((("head",), (d, vp), "normal", d ** -0.5))
    return out


def leaf_seed(seed: int, index: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) \
        % (1 << 63)


def make_leaf(s: Dict, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` of ``leaf_specs`` drawn on ``device`` in the
    configuration's dtype, from a generator of its own."""
    _, shape, law, scale = leaf_specs(s)[index]
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    if law == "sign":
        bits = torch.randint(0, 2, shape, generator=gen, device=device,
                             dtype=torch.int8)
        return (bits * 2 - 1).to(s["dtype"])
    t = torch.randn(shape, generator=gen, device=device, dtype=s["dtype"])
    t.mul_(scale)
    if law == "norm":
        t.add_(1.0)
    return t


def make_weights(config: Dict, seed: int, device) -> Dict:
    """Every leaf, in the port's param tree (``segments`` a one-element
    list; SRF params a one-block tuple)."""
    s = sizes(config)
    tree: Dict = {}
    for i, (path, *_rest) in enumerate(leaf_specs(s)):
        _put(tree, path, make_leaf(s, seed, i, device))
    seg = tree["segments"]
    tree["segments"] = [seg[0]]
    if "srf" in seg[0]["attn"]:
        seg[0]["attn"]["srf"] = (seg[0]["attn"]["srf"][0],)
    return tree


def _put(tree, path, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# -- arithmetic ---------------------------------------------------------------

@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """float32 matmuls in float32: TF32 off for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class _Q8(torch.autograd.Function):
    """Round to float8 e4m3 with one scale for the tensor; the gradient
    passes straight through."""

    @staticmethod
    def forward(ctx, t):
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, g):
        return g


def q(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """A matmul operand as the reference's precision holds it."""
    if quant is None:
        return t
    if quant == "fp8":
        return _Q8.apply(t)
    raise ValueError(f"quant {quant!r}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., L, hd), pos (L,): half-split rotary embedding."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def hadamard(n: int, device) -> torch.Tensor:
    """Sylvester's Hadamard matrix of order n, normalized."""
    h = torch.ones((1, 1), device=device)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h / math.sqrt(n)


def srf_projection(g: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
                   m: int) -> torch.Tensor:
    """(m, n) matrix A D1 H D0 of one head: A stacks circulant blocks,
    A_b[i, j] = g_b[(j - i) mod n]."""
    nb, n = g.shape
    i = torch.arange(n, device=g.device)[:, None]
    j = torch.arange(n, device=g.device)[None, :]
    a = g[:, (j - i) % n].reshape(nb * n, n)[:m]
    return (a * d1[None, :]) @ hadamard(n, g.device) * d0[None, :]


def srf_features(x: torch.Tensor, w: torch.Tensor, is_query: bool,
                 quant: Optional[str]) -> torch.Tensor:
    """Positive softmax-kernel features of rows x (..., n) under the
    projection w (..., m, n), one a leading group: exp(w x' - |x'|^2 / 2)
    / sqrt(m), x' = x n^-1/4; a query's row is shifted by its largest
    exponent first."""
    n, m = x.shape[-1], w.shape[-2]
    xs = x * n ** -0.25
    z = q(xs, quant) @ q(w, quant).transpose(-1, -2) \
        - 0.5 * torch.sum(xs * xs, -1, keepdim=True)
    if is_query:
        z = z - torch.amax(z, dim=-1, keepdim=True).detach()
    return torch.exp(z) / math.sqrt(m)


def causal_linear(pq: torch.Tensor, pk: torch.Tensor, v: torch.Tensor,
                  chunk: int, quant: Optional[str], eps: float = 1e-6
                  ) -> torch.Tensor:
    """out_i = sum_{j<=i} (pq_i . pk_j) v_j / (sum_{j<=i} pq_i . pk_j +
    eps) over (H, L, .) rows, a chunk of keys at a time."""
    h, l, m = pq.shape
    s = torch.zeros((h, m, v.shape[-1]), device=pq.device)
    z = torch.zeros((h, m), device=pq.device)
    outs = []
    for a in range(0, l, chunk):
        qc, kc, vc = (t[:, a:a + chunk] for t in (pq, pk, v))
        c = qc.shape[1]
        tri = torch.tril(torch.ones((c, c), device=pq.device))
        att = (q(qc, quant) @ q(kc, quant).transpose(1, 2)) * tri
        num = q(att, quant) @ q(vc, quant) + q(qc, quant) @ q(s, quant)
        den = att.sum(-1) + (qc * z[:, None, :]).sum(-1)
        outs.append(num / (den[..., None] + eps))
        s = s + q(kc, quant).transpose(1, 2) @ q(vc, quant)
        z = z + kc.sum(1)
    return torch.cat(outs, dim=1)


def causal_softmax(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                   quant: Optional[str], q_chunk: int = 1024
                   ) -> torch.Tensor:
    """Causal softmax attention of (H, L, hd) rows, GQA by head groups
    (query head i reads kv head i // (H / Hkv)), a block of queries at a
    time."""
    hq, l, hd = qh.shape
    g = hq // kh.shape[0]
    kh = kh.repeat_interleave(g, dim=0)
    vh = vh.repeat_interleave(g, dim=0)
    outs = []
    cols = torch.arange(l, device=qh.device)
    for a in range(0, l, q_chunk):
        qc = qh[:, a:a + q_chunk]
        s = (q(qc, quant) @ q(kh, quant).transpose(1, 2)) / math.sqrt(hd)
        rows = torch.arange(a, a + qc.shape[1], device=qh.device)
        s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        outs.append(q(torch.softmax(s, dim=-1), quant) @ q(vh, quant))
    return torch.cat(outs, dim=1)


def layer(s: Dict, p: Dict, x: torch.Tensor, pos: torch.Tensor,
          quant: Optional[str]) -> torch.Tensor:
    """One decoder layer on the rows x (L, d) of one sequence; ``p``
    holds the layer's float32 leaves."""
    hq, hkv, hd = s["hq"], s["hkv"], s["hd"]
    l = x.shape[0]
    h = rmsnorm(x, p["ln1"], s["eps"])
    hq8 = q(h, quant)
    qh = (hq8 @ q(p["wq"], quant)).view(l, hq, hd).transpose(0, 1)
    kh = (hq8 @ q(p["wk"], quant)).view(l, hkv, hd).transpose(0, 1)
    vh = (hq8 @ q(p["wv"], quant)).view(l, hkv, hd).transpose(0, 1)
    qh = rope(rmsnorm(qh, p["q_norm"], s["eps"]), pos, s["theta"])
    kh = rope(rmsnorm(kh, p["k_norm"], s["eps"]), pos, s["theta"])
    if s["attn"] == "srf":
        g = hq // hkv
        w = torch.stack([srf_projection(p["srf_g"][k], p["srf_d0"][k],
                                        p["srf_d1"][k], s["m"])
                         for k in range(hkv)])           # (Hkv, m, hd)
        pq = srf_features(qh.reshape(hkv, g * l, hd), w, True, quant)
        pk = srf_features(kh, w, False, quant)
        o = causal_linear(pq.reshape(hq, l, -1), pk.repeat_interleave(g, 0),
                          vh.repeat_interleave(g, 0), LINEAR_CHUNK, quant)
    else:
        o = causal_softmax(qh, kh, vh, quant)
    x = x + q(o.transpose(0, 1).reshape(l, hq * hd), quant) @ q(p["wo"],
                                                                 quant)
    h2 = q(rmsnorm(x, p["ln2"], s["eps"]), quant)
    a = F.silu(h2 @ q(p["wg"], quant)) * (h2 @ q(p["wi"], quant))
    return x + q(a, quant) @ q(p["mwo"], quant)


_LAYER_LEAVES = {"ln1": ("ln1", "w"), "wq": ("attn", "wq"),
                 "wk": ("attn", "wk"), "wv": ("attn", "wv"),
                 "wo": ("attn", "wo"), "q_norm": ("attn", "q_norm"),
                 "k_norm": ("attn", "k_norm"), "ln2": ("ln2", "w"),
                 "wi": ("mlp", "wi"), "wg": ("mlp", "wg"),
                 "mwo": ("mlp", "wo"), "srf_g": ("attn", "srf", 0, "g"),
                 "srf_d0": ("attn", "srf", 0, "d0"),
                 "srf_d1": ("attn", "srf", 0, "d1")}


def layer_params(seg: Dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's leaves of a segment tree, as float32 copies."""
    out = {}
    for name, path in _LAYER_LEAVES.items():
        try:
            out[name] = get(seg, path)[i].float()
        except KeyError:
            continue
    return out


@torch.no_grad()
def logits_from(config: Dict, weights: Dict, tokens: Sequence[int],
                first: int, quant: Optional[str] = None) -> torch.Tensor:
    """float32 logits (len(tokens) - first + 1, vocab) of the positions
    first - 1 .. len(tokens) - 1 (each predicts the token after it): the
    whole sequence through every layer, one layer's weights in float32
    at a time."""
    s = sizes(config)
    seg = weights["segments"][0]
    dev = weights["embed"]["tok"].device
    with exact_f32():
        ids = torch.as_tensor(list(tokens), device=dev, dtype=torch.long)
        pos = torch.arange(len(ids), device=dev)
        x = weights["embed"]["tok"][ids].float()
        for i in range(s["layers"]):
            x = layer(s, layer_params(seg, i), x, pos, quant)
        h = rmsnorm(x[first - 1:], weights["final_norm"]["w"].float(),
                    s["eps"])
        head = weights["embed"]["tok"][: s["vocab"]].float().T \
            if s["tied"] else weights["head"][:, : s["vocab"]].float()
        return q(h, quant) @ q(head, quant)


# -- training -----------------------------------------------------------------

def _seq_loss(s: Dict, leaves: Dict, tokens: torch.Tensor,
              labels: torch.Tensor, quant: Optional[str],
              rows: int = 256) -> torch.Tensor:
    """Summed cross entropy of one sequence over the padded vocabulary
    (labels past the vocabulary count nothing), each layer and each
    block of ``rows`` logits rows recomputed in the backward."""
    from torch.utils.checkpoint import checkpoint
    pos = torch.arange(len(tokens), device=tokens.device)
    x = leaves[("embed", "tok")][tokens]
    seg = _unflatten(leaves)["segments"][0]
    for i in range(s["layers"]):
        x = checkpoint(lambda xx, i=i: layer(s, layer_params(seg, i), xx,
                                             pos, quant), x,
                       use_reentrant=False)
    h = rmsnorm(x, leaves[("final_norm", "w")], s["eps"])
    head = leaves[("embed", "tok")].T if s["tied"] else leaves[("head",)]

    def block(hb, lb):
        lg = q(hb, quant) @ q(head, quant)
        nll = torch.logsumexp(lg, -1) - lg.gather(
            1, lb.clamp(0, lg.shape[1] - 1)[:, None])[:, 0]
        return torch.where(lb < s["vocab"], nll, 0.0).sum()
    return sum(checkpoint(block, h[a:a + rows], labels[a:a + rows],
                          use_reentrant=False)
               for a in range(0, len(tokens), rows))


def _unflatten(leaves: Dict) -> Dict:
    tree: Dict = {}
    for path, t in leaves.items():
        _put(tree, path, t)
    return tree


def _blocks(*ts: torch.Tensor):
    """Matching views of at most 2^26 elements, along the leading axis."""
    t0 = ts[0]
    rows = max(1, (1 << 26) // max(1, t0[0].numel())) if t0.dim() else 1
    if t0.dim() == 0 or t0.shape[0] <= rows:
        return [ts]
    return [tuple(t[a:a + rows] for t in ts)
            for a in range(0, t0.shape[0], rows)]


def _adamw(w, g, mu, nu, adam: Dict, lr: float, decay: float, c1: float,
           c2: float, dtype) -> None:
    """One AdamW step of a block, in place; the weight is then rounded to
    the configuration's precision."""
    mu.mul_(adam["b1"]).add_(g, alpha=1 - adam["b1"])
    nu.mul_(adam["b2"]).addcmul_(g, g, value=1 - adam["b2"])
    upd = (mu / c1).div_(torch.sqrt(nu / c2).add_(adam["eps"]))
    if decay:
        upd.add_(w, alpha=decay)
    w.sub_(upd, alpha=lr)
    w.copy_(w.to(dtype))


def train_reference(config: Dict, seed: int, batches, lr: float,
                    adam: Dict, device, quant: Optional[str] = None
                    ) -> Dict[str, object]:
    """Train from the seed's weights on ``batches`` [(tokens, labels)
    (B, L) each] with AdamW as the configuration runs it (clip by the
    global norm, bias-corrected f32 moments, decoupled decay on all but
    the norm gains), the weights held at the configuration's precision
    between steps. -> {"loss": [a step], "grad": {leaf: norm of the
    first step's clipped gradient}, "change": {leaf: norm of the weights'
    change over all steps}}."""
    s = sizes(config)
    specs = leaf_specs(s)
    names = ["/".join(map(str, p)) for p, *_r in specs]
    with exact_f32():
        leaves = {p: make_leaf(s, seed, i, device).float().requires_grad_()
                  for i, (p, *_r) in enumerate(specs)}
        mu = {p: torch.zeros_like(t) for p, t in leaves.items()}
        nu = {p: torch.zeros_like(t) for p, t in leaves.items()}
        out: Dict[str, object] = {"loss": [], "grad": {}, "change": {}}
        for step, (tokens, labels) in enumerate(batches):
            count = (labels < s["vocab"]).sum()
            loss = sum(_seq_loss(s, leaves, t, lb, quant)
                       for t, lb in zip(tokens, labels)) / count
            grads = torch.autograd.grad(loss, list(leaves.values()))
            out["loss"].append(float(loss.detach()))
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(adam["clip_norm"] / (gnorm + 1e-9), max=1.0)
            c1 = 1.0 - adam["b1"] ** (step + 1)
            c2 = 1.0 - adam["b2"] ** (step + 1)
            with torch.no_grad():
                for i, ((p, w), g) in enumerate(zip(leaves.items(), grads)):
                    g.mul_(scale)
                    if step == 0:
                        out["grad"][names[i]] = float(
                            torch.linalg.vector_norm(g))
                    decay = adam["weight_decay"] if specs[i][2] != "norm" \
                        else 0.0
                    for blk in _blocks(w, g, mu[p], nu[p]):
                        _adamw(*blk, adam, lr, decay, c1, c2, s["dtype"])
            del grads
        del mu, nu
        with torch.no_grad():
            for i, (p, w) in enumerate(leaves.items()):
                out["change"][names[i]] = float(torch.linalg.vector_norm(
                    w - make_leaf(s, seed, i, device).float()))
    return out

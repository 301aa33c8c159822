"""The MoE family (moonshot-v1-16b-a3b) in the port against the reference
on the CPU: reduced configs (f32), the reference's params carried over
with ``convert.params_from_jax``.

* The MoE layer (``models/moe.py``) against ``repro.models.moe`` on the
  reduced moonshot and deepseek configs: outputs within 1e-5 of the
  largest, the aux loss within 1e-6 relative, and the integer routing
  exactly equal (top-k expert ids, and the (B, E, cap) slot map of token
  ids, read back from the payload buffer the reference hands its
  ``moe_buf`` sharding hook), with ``valid``, with capacity drops (cf
  0.25), without (cf 8.0; also equal to both dense oracles) and with a
  zero router (every probability ties: the lower expert index first, as
  ``jax.lax.top_k``). Gradients of a MoE loss against ``jax.grad``'s.
* The model (2 layers: one dense, one moe, cf 8.0 as the reference's
  parity tests): forward, loss and aux; prefill and decode against the
  forward and against the reference; the paged step with full-KV pages,
  int8 pages and SRF state against the reference's jitted step.
* The engines: greedy tokens of the port's paged engine equal its legacy
  engine's and the reference paged engine's, sampled tokens the
  reference's (int8 pages: greedy, paged only); the serve CLI.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe_mod
from repro import serving as jserving
from repro.configs import registry as jregistry
from repro.models import moe as jM
from repro.models import transformer as jT
from repro.serving import paged_cache as jcache
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving import Engine, PagedConfig, Request, paged_cache

ARCH = "moonshot-v1-16b-a3b"
MOE_ARCHS = [ARCH, "deepseek-v2-lite-16b"]
OUT_RTOL = 1e-5        # of the largest |output| (f32, other sum orders)
AUX_RTOL = 1e-6
LOGIT_RTOL = 1e-4      # of the largest |logit|, through the layers
# cell -> (config overrides, int8 pages)
CELLS = {"full": ({}, False), "int8": ({}, True),
         "srf": ({"attn_impl": "srf"}, False)}

_models = {}


def models(arch=ARCH, **over):
    """Both packages' reduced configs (2 layers, cf 8.0 as the
    reference's parity tests) and params (cached)."""
    over = {"n_layers": 2, "moe_capacity_factor": 8.0, **over}
    key = (arch, tuple(sorted(over.items())))
    if key not in _models:
        jcfg = jregistry.reduced(arch, **over)
        cfg = registry.reduced(arch, **over)
        jparams = jax.jit(jT.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        _models[key] = (jcfg, jparams, cfg, params)
    return _models[key]


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a.astype(jnp.float32))


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_params(arch, **over):
    """The moe layer's params of the reduced model, in both packages."""
    jcfg, jparams, cfg, params = models(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][1]["moe"])
    p = jax.tree.map(lambda t: t[0], params["segments"][1]["moe"])
    return (dataclasses.replace(jcfg, **over), jp,
            dataclasses.replace(cfg, **over), p)


def _ref_apply(jp, jcfg, x, valid, monkeypatch):
    """The reference's moe_apply and the (B, E, cap) token id of every
    slot it filled, read off the payload buffer it passes its sharding
    hook (``_constrain(buf, "moe_buf")``, returned from the jitted call):
    x's rows are distinct and none is zero, so each buffer row is exactly
    one row of [x | 0] (the zero row: an empty slot, id L)."""
    seen = []
    monkeypatch.setattr(jmoe_mod, "_constrain",
                        lambda a, role: seen.append(a) or a)

    def run(p, x, *valid):
        return (*jM.moe_apply(p, jcfg, x, *valid), seen[0])
    out, aux, buf = jax.jit(run)(jp, jnp.asarray(x), *(
        () if valid is None else (jnp.asarray(valid),)))
    buf = np.asarray(buf)                           # (B, E, cap, d)
    b, l, d = x.shape
    xpad = np.concatenate([x, np.zeros((b, 1, d), x.dtype)], axis=1)
    hit = (buf[:, :, :, None, :] == xpad[:, None, None, :, :]).all(-1)
    assert (hit.sum(-1) == 1).all()
    return out, aux, hit.argmax(-1)


MOE_CASES = {"valid": dict(cf=1.25, b=2, l=24, valid=True),
             "drops": dict(cf=0.25, b=2, l=64),
             "no drops": dict(cf=8.0, b=2, l=24),
             "zero router": dict(cf=1.25, b=4, l=64, zero=True)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(arch, case, monkeypatch):
    c = MOE_CASES[case]
    jcfg, jp, cfg, p = _moe_params(arch, moe_capacity_factor=c["cf"])
    if c.get("zero"):
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
        p = dict(p, router=torch.zeros_like(p["router"]))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((c["b"], c["l"], cfg.d_model)).astype(np.float32)
    valid = None
    if c.get("valid"):
        valid = np.arange(c["l"])[None] < np.array([[c["l"]], [13]])
    want, jaux, want_slots = _ref_apply(jp, jcfg, x, valid, monkeypatch)
    xt = torch.from_numpy(x)
    vt = None if valid is None else torch.from_numpy(valid)
    out, aux = M.moe_apply(p, cfg, xt, vt)
    _close(out, want, OUT_RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    r = M.route(p, cfg, xt, vt)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    np.testing.assert_array_equal(
        r["idx"].numpy(), np.asarray(jax.lax.top_k(jprobs, cfg.moe_top_k)[1]))
    slots = M.slot_map(r, c["l"]).numpy()
    np.testing.assert_array_equal(slots, want_slots)
    # keep: (token, expert) pairs the reference gave a slot
    keep = np.array([[[t in want_slots[bi, e] for e in row]
                      for t, row in enumerate(r["idx"][bi].numpy())]
                     for bi in range(c["b"])])
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    if case == "drops":
        assert not keep.all()
    if case == "no drops":
        assert keep.all()
        _close(M.moe_dense_reference(p, cfg, xt),
               jM.moe_dense_reference(jp, jcfg, jnp.asarray(x)), OUT_RTOL)
        _close(out, M.moe_dense_reference(p, cfg, xt), OUT_RTOL)
    if case == "zero router":      # every tie: experts 0..k-1, aux 1
        assert (r["idx"].numpy() == np.arange(cfg.moe_top_k)).all()
        assert abs(float(aux) - 1.0) < 1e-6
    if valid is not None:          # padded tokens take no slot
        assert not r["keep"].numpy()[~valid].any()


def test_top_k_breaks_ties_as_jax():
    """Among equal values the lower index comes first, as in
    ``jax.lax.top_k``."""
    v = np.array([[0.1, 0.3, 0.3, 0.1, 0.3, 0.0], [1, 1, 1, 1, 1, 1]],
                 np.float32)
    vals, idx = M._top_k(torch.from_numpy(v), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(v), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradients_match_jax_grad(arch):
    """sum(y²) + 0.01 aux (``tests/test_moe.py``'s loss at cf 4.0):
    every leaf's gradient (router, experts, shared experts) within 1e-5
    of its largest, and nonzero."""
    jcfg, jp, cfg, p = _moe_params(arch, moe_capacity_factor=4.0)
    x = np.random.default_rng(2).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32)

    def jloss(pp):
        y, aux = jM.moe_apply(pp, jcfg, jnp.asarray(x))
        return jnp.sum(y ** 2) + 0.01 * aux
    want = jax.jit(jax.grad(jloss))(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()
              if k != "shared"}
    leaves["shared"] = {k: v.clone().requires_grad_(True)
                        for k, v in p["shared"].items()}
    y, aux = M.moe_apply(leaves, cfg, torch.from_numpy(x))
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    for k in ("router", "wi", "wg", "wo"):
        assert float(leaves[k].grad.abs().max()) > 0
        _close(leaves[k].grad, want[k], OUT_RTOL)
    for k in ("wi", "wg", "wo"):
        _close(leaves["shared"][k].grad, want["shared"][k], OUT_RTOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_convert_and_init_keep_the_moe_tree():
    """The reference's tree carried over leaf for leaf (two segments,
    dense then moe; router, experts, shared); in a bf16 model the router
    stays f32, from the port's init and from the converter."""
    jcfg, jparams, cfg, params = models()
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), params))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert T.segments(cfg) == jT.segments(jcfg) == [("dense", 1), ("moe", 1)]
    assert set(params["segments"][1]["moe"]) == {"router", "wi", "wg", "wo",
                                                 "shared"}
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    for tree in (T.init(bf, seed=0, device="cpu"),
                 convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         bf, device="cpu")):
        moe = tree["segments"][1]["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["wi"].dtype == moe["shared"]["wo"].dtype == torch.bfloat16
    mine = T.init(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda t: tuple(t.shape), params)


def test_forward_and_loss_match_reference():
    """Logits within 1e-4 of the largest, the loss and the summed aux
    loss (weighted 0.01 into it) within 1e-5 relative."""
    jcfg, jparams, cfg, params = models()
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want, jloss, jm = jax.jit(lambda p, b: (
        jT.forward(p, jcfg, {"tokens": b["tokens"]})[0],
        *jT.loss_fn(p, jcfg, b)))(jparams, jax.tree.map(jnp.asarray, batch))
    got, aux = T.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert torch.isfinite(got).all() and float(aux) > 0
    _close(got, want, LOGIT_RTOL)
    loss, m = T.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5)


def test_prefill_decode_consistency():
    """tests/test_models_smoke.py:93 on the port (cf 8.0): prefill and
    decode logits equal the training forward's within 2e-4 of its
    largest."""
    cfg = registry.reduced(ARCH, moe_capacity_factor=8.0)
    params = T.init(cfg, seed=0, device="cpu")
    b, p, n = 2, 16, 3
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, p + n)))
    full, _ = T.forward(params, cfg, {"tokens": toks})
    cache = T.init_serve_cache(cfg, b, p + n, device="cpu")
    lp, cache = T.prefill(params, cfg, {"tokens": toks[:, :p]}, cache)
    scale = float(full.abs().max())
    errs = [float((lp[:, 0] - full[:, p - 1]).abs().max())]
    for i in range(n):
        ld, cache = T.decode_step(params, cfg, cache,
                                  toks[:, p + i:p + i + 1])
        errs.append(float((ld[:, 0] - full[:, p + i]).abs().max()))
    assert max(errs) / scale < 2e-4, errs


def test_prefill_decode_match_reference():
    """The legacy engine's cache path (a prompt of 10, three decode
    steps) against the reference's: logits and the KV caches."""
    jcfg, jparams, cfg, params = models()
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 13))
    jc = jT.init_serve_cache(jcfg, 2, 16)
    c = T.init_serve_cache(cfg, 2, 16, device="cpu")
    jdecode = jax.jit(jT.decode_step, static_argnums=1)
    want, jc = jax.jit(jT.prefill, static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, :10])}, jc)
    got, c = T.prefill(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :10])}, c)
    _close(got, want, LOGIT_RTOL)
    for t in range(10, 13):
        want, jc = jdecode(jparams, jcfg, jc, jnp.asarray(toks[:, t:t + 1]))
        got, c = T.decode_step(params, cfg, c,
                               torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want, LOGIT_RTOL)
    for seg, jseg in zip(c["segments"], jc["segments"]):
        for k in ("k", "v"):
            _close(seg[k], jseg[k], LOGIT_RTOL)
        assert seg["idx"] == int(jseg["idx"][0]) == 13 == c["pos"]


_ref_steps = {}


def _ref_engine(jcfg, jparams, quant=False, **kw):
    """A reference paged engine; engines of one (config, page layout)
    share the first one's jitted step (the reference jits anew per
    engine)."""
    eng = jserving.Engine(jcfg, jparams, paged=jserving.PagedConfig(quant),
                          **kw)
    eng._step = _ref_steps.setdefault((eng.cfg, eng.paged), eng._step)
    return eng


def _steps(vocab, b, c, seed=0):
    """A chunked-prefill step (rows of c, 5 and c - 3 valid tokens and a
    padding row on the null page and slot), then two decode steps."""
    rng = np.random.default_rng(seed)
    lengths = np.array([c, 5] + [c - 3] * (b - 3) + [0])
    steps = [(rng.integers(0, vocab, (b, c)).astype(np.int32),
              np.tile(np.arange(c, dtype=np.int32), (b, 1)),
              np.arange(c)[None, :] < lengths[:, None])]
    for t in range(2):
        steps.append((rng.integers(0, vocab, (b, 1)).astype(np.int32),
                      (lengths + t)[:, None].astype(np.int32),
                      (lengths > 0)[:, None]))
    return steps


@pytest.mark.parametrize("cell", list(CELLS))
def test_paged_step_matches_reference(cell):
    """At a 4-slot engine's pool geometry and batch shapes, against the
    step that engine jits: the live rows' logits after every step within
    1e-4 of the largest, and every page and slot but the null ones (int8
    pages exactly). The moe layer routes with ``valid=q_valid``."""
    over, quant = CELLS[cell]
    jcfg, jparams, cfg, params = models(**over)
    eng = _ref_engine(jcfg, jparams, quant, batch_slots=4, max_len=64)
    sc, n_slots = eng.sched_cfg, eng.sched.num_slots
    b, c, w = sc.max_batch, sc.prefill_chunk, sc.table_width
    jpools = jcache.init_pools(jcfg, sc.num_pages, sc.page_size,
                               num_slots=n_slots,
                               paged=jcache.PagedConfig(quant))
    pools = paged_cache.init_pools(cfg, sc.num_pages, sc.page_size,
                                   num_slots=n_slots, device="cpu",
                                   paged=paged_cache.PagedConfig(quant))
    slots = np.array([1, 3, 4, 0], np.int32)
    tables = np.zeros((b, w), np.int32)
    if eng.plan.has_paged:
        tables[:-1] = np.arange(1, 1 + (b - 1) * w).reshape(b - 1, w)
    for tok, pos, qv in _steps(cfg.vocab, b, c):
        want, jpools = eng._step(jparams, jpools, *map(jnp.asarray, (
            tok, pos, qv, tables, slots)))
        got, pools = T.paged_step(params, cfg, pools, torch.from_numpy(tok),
                                  torch.from_numpy(pos).long(),
                                  torch.from_numpy(qv),
                                  torch.from_numpy(tables).long(),
                                  torch.from_numpy(slots).long())
        live = qv.any(axis=1)
        _close(_np(got)[live], _np(want)[live], LOGIT_RTOL)
    for part in ("paged", "slot"):
        for seg, jseg in zip(pools[part], jpools[part]):
            assert (seg is None) == (jseg is None)
            for comp, leaves in (seg or {}).items():
                for k, a in leaves.items():
                    g, wnt = _np(a)[:, 1:], _np(jseg[comp][k])[:, 1:]
                    if a.dtype == torch.int8:
                        np.testing.assert_array_equal(g, wnt)
                    else:
                        _close(g, wnt, LOGIT_RTOL)


def test_plan_and_bytes_per_token_match_reference():
    """moonshot's plans (kv, int8 kv, srf) and per-layer bytes a token
    equal the reference's, reduced and at full width; full width holds
    393,216 B of bf16 KV a token (48 layers x 2 x 16 heads x 128 x 2)."""
    for name in ("reduced", "full"):
        for over, quant, plan in (({}, False, "kv"), ({}, True, "kv"),
                                  ({"attn_impl": "srf"}, False, "srf")):
            cfg, jcfg = ((registry.reduced(ARCH, **over),
                          jregistry.reduced(ARCH, **over)) if name == "reduced"
                         else (registry.get(ARCH, **over),
                               jregistry.get(ARCH, **over)))
            pp, jp = paged_cache.plan_for(cfg), jcache.plan_for(jcfg)
            assert pp.name == jp.name == plan
            assert pp.segments == jp.segments
            assert pp.bytes_per_token(cfg, 256, PagedConfig(quant)) == \
                jp.bytes_per_token(jcfg, 256, jcache.PagedConfig(quant))
    full = registry.get(ARCH)
    assert paged_cache.plan_for(full).bytes_per_token(full, 256) \
        * full.n_layers == 393216


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _requests(cls, cfg, n, seed=0, temperature=0.0):
    """test_engine_parity._requests's recipe."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab, int(
        rng.integers(2, 20))).astype(np.int32),
        max_new=int(rng.integers(3, 7)), temperature=temperature)
        for i in range(n)]


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    for r in done:
        assert r.t_submit <= r.t_first <= r.t_done
    return {r.uid: list(r.out_tokens) for r in done}


PARITY = [("full", 0.0), ("full", 0.8), ("int8", 0.0), ("srf", 0.0)]


@pytest.mark.parametrize("cell,temperature", PARITY,
                         ids=[f"{c}-{'sampled' if t else 'greedy'}"
                              for c, t in PARITY])
def test_paged_equals_legacy_equals_reference(cell, temperature):
    """8 mixed-length requests, 4 slots (tests/test_engine_parity.py:95,
    :125): the port's paged tokens equal the reference paged engine's,
    greedy and sampled, and the port's legacy engine's (int8 pages: the
    paged engine alone; the legacy int8 cache quantizes per token and
    head)."""
    over, quant = CELLS[cell]
    jcfg, jparams, cfg, params = models(**over)
    eng = Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                 device="cpu", paged=PagedConfig(quant))
    paged = _drive(eng, _requests(Request, cfg, 8, 0, temperature))
    assert len(paged) == 8 and eng.nonfinite_rows == 0
    ref = _ref_engine(jcfg, jparams, quant, batch_slots=4, max_len=64,
                      seed=5)
    assert paged == _drive(ref, _requests(jserving.Request, jcfg, 8, 0,
                                          temperature))
    assert eng.sched.alloc.used_pages == 0
    if quant:
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving import legacy
    leg = legacy.Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                        device="cpu")
    assert _drive(leg, _requests(Request, cfg, 8, 0, temperature)) == paged


CLI = [([], "'family': 'kv'"), (["--quantize-kv"], "'family': 'kv'"),
       (["--attn", "srf"], "'family': 'srf'"), (["--legacy"], "engine=legacy")]


@pytest.mark.parametrize("flags,expect", CLI,
                         ids=["".join(f) or "full" for f, _ in CLI])
def test_cli_serves_reduced_on_cpu(capsys, flags, expect):
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--prompt-len", "20", "--max-new", "4", "--slots", "2"]
    assert serve.main(args + flags) == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=12" in out and expect in out

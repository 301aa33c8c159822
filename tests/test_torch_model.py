"""The port's paged model step against ``repro.models.transformer`` on the
CPU: reduced qwen3-4b with SRF attention and with full-KV pages (bf16/f32
or int8), the reference's params carried over with
``convert.params_from_jax``. One chunked-prefill step and four batched
decode steps must give the same logits (rtol=1e-3, atol=1e-4, f32: the
frameworks' matmuls, FFTs and exp sum and round differently, and the
error grows through the layers) and the same SRF slot states / KV pages.

The same SRF steps in bf16 (the full-width dtype: bf16 weights,
activations and state pools) are held to the reference with its Pallas
kernels in interpret mode, i.e. the TPU kernels' numerics. One layer's
full-KV attention (``_paged_full``) is held to the reference's on the
same inputs, bf16 and int8 pools.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jA
from repro.models import transformer as jT
from repro.serving import paged_cache as jcache
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serving import paged_cache

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

TOL = dict(rtol=1e-3, atol=1e-4)


def _models(attn, arch="qwen3-4b"):
    jcfg = jregistry.reduced(arch, attn_impl=attn)
    cfg = registry.reduced(arch, attn_impl=attn)
    jparams = jT.init(jax.random.PRNGKey(0), jcfg)
    if jcfg.qkv_bias:    # the reference inits q/k/v biases to zeros
        rng = np.random.default_rng(7)
        attn_p = jparams["segments"][0]["attn"]
        for name in ("bq", "bk", "bv"):
            attn_p[name] = jnp.asarray(
                rng.standard_normal(attn_p[name].shape) * 0.1, jnp.float32)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def models():
    return _models("srf")


@pytest.fixture(scope="module")
def kv_models():
    return _models("full")


@pytest.mark.parametrize("attn", ["srf", "full"])
def test_convert_keeps_layout_and_values(models, kv_models, attn):
    """Both ways: the reference's tree carried over leaf for leaf (an SRF
    tree with its ``attn.srf`` generators, a full-attention tree with
    none), and the port's own init has the same layout and shapes."""
    jcfg, jparams, cfg, params = models if attn == "srf" else kv_models
    assert ("srf" in params["segments"][0]["attn"]) == (attn == "srf")
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), params))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b)
    mine = T.init(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda t: tuple(t.shape), params)
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_jax({"embed": {}}, cfg, device="cpu")


def _steps(vocab, seed=0):
    """One chunked-prefill step (rows of 8, 5 and 0 valid tokens; row 2 is
    padding on the null slot 0) and four decode steps, as numpy."""
    rng = np.random.default_rng(seed)
    b, c = 3, 8
    lengths = np.array([8, 5, 0])
    tokens = rng.integers(0, vocab, (b, c)).astype(np.int32)
    pos = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    qv = np.arange(c)[None, :] < lengths[:, None]
    steps = [(tokens, pos, qv)]
    for t in range(4):
        tok = rng.integers(0, vocab, (b, 1)).astype(np.int32)
        steps.append((tok, (lengths + t)[:, None].astype(np.int32),
                      (lengths > 0)[:, None]))
    return steps


SLOTS = np.array([1, 3, 0], np.int32)
# SRF plans use one slot per row and no pages; kv plans 4 pages of 4
# tokens per row (row 2 is padding on the null page 0)
GEOMETRY = {"srf": (2, 16, np.zeros((3, 1), np.int32)),
            "full": (9, 4, np.array([[1, 2, 3, 4], [5, 6, 7, 8],
                                     [0, 0, 0, 0]], np.int32))}


def _run_jax(jparams, jcfg, steps, quantize_kv=False):
    """-> (live logit rows of every step as f32 numpy, final pools)."""
    n, p, tables = GEOMETRY[jcfg.attn_impl]
    pools = jcache.init_pools(jcfg, n, p, num_slots=4,
                              paged=jcache.PagedConfig(quantize_kv))
    out = []
    for tok, p, v in steps:
        logits, pools = jT.paged_step(jparams, jcfg, pools, jnp.asarray(tok),
                                      jnp.asarray(p), jnp.asarray(v),
                                      jnp.asarray(tables), jnp.asarray(SLOTS))
        out.append(np.asarray(logits.astype(jnp.float32))[v.any(axis=1)])
    return out, pools


def _run_port(params, cfg, steps, quantize_kv=False):
    n, p, tables = GEOMETRY[cfg.attn_impl]
    pools = paged_cache.init_pools(cfg, n, p, num_slots=4, device="cpu",
                                   paged=paged_cache.PagedConfig(quantize_kv))
    out = []
    for tok, p, v in steps:
        logits, pools = T.paged_step(params, cfg, pools,
                                     torch.from_numpy(tok),
                                     torch.from_numpy(p),
                                     torch.from_numpy(v),
                                     torch.from_numpy(tables),
                                     torch.from_numpy(SLOTS))
        out.append(logits.float().numpy()[v.any(axis=1)])
    return out, pools


def _state(pools, key):
    """Live slots 1 and 3 of the SRF pool, as f32 numpy."""
    a = pools["slot"][0]["attn"][key][:, [1, 3]]
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a.astype(jnp.float32)))


def test_paged_step_logits_match_reference(models):
    jcfg, jparams, cfg, params = models
    steps = _steps(cfg.vocab)
    want, jpools = _run_jax(jparams, jcfg, steps)
    got, pools = _run_port(params, cfg, steps)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    for key in ("s", "z"):
        np.testing.assert_allclose(_state(pools, key), _state(jpools, key),
                                   **TOL)


def test_paged_step_bf16_matches_reference_kernels(monkeypatch):
    """bf16 logits and state within 2e-2 of their largest magnitude (the
    bf16 tolerance of ``chip_smoke.py``). Both sides round every matmul,
    the logits and the pools to bf16, in different places, so they part
    by a few bf16 spacings: 1.3e-2 at most over seeds 0-2, while the
    reference's bf16 run parts from its f32 run at the same weights by up
    to 2.0e-2. A second check: the port's bf16 run is no farther from
    that f32 run than the reference's bf16 run is (RMS over the logits;
    ratio 0.93-0.99 measured), so no cast of the port adds error of its
    own. The sharp bf16 check is per kernel, in test_torch_kernels."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "interpret")
    jcfg = jregistry.reduced("qwen3-4b", attn_impl="srf", dtype="bfloat16")
    cfg = registry.reduced("qwen3-4b", attn_impl="srf", dtype="bfloat16")
    jparams = jT.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    assert params["embed"]["tok"].dtype == torch.bfloat16
    steps = _steps(cfg.vocab)
    want, jpools = _run_jax(jparams, jcfg, steps)
    got, pools = _run_port(params, cfg, steps)
    assert pools["slot"][0]["attn"]["s"].dtype == torch.bfloat16

    def close(g, w):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-2 * np.abs(w).max())
    for g, w in zip(got, want):
        close(g, w)
    for key in ("s", "z"):
        close(_state(pools, key), _state(jpools, key))

    f32 = lambda t: t.astype(jnp.float32) \
        if jnp.issubdtype(t.dtype, jnp.floating) else t        # noqa: E731
    exact, _ = _run_jax(jax.tree.map(f32, jparams),
                        jregistry.reduced("qwen3-4b", attn_impl="srf"), steps)
    rms = lambda a, b: float(np.sqrt(np.mean(                  # noqa: E731
        np.square(np.concatenate([x.ravel() for x in a])
                  - np.concatenate([x.ravel() for x in b])))))
    assert rms(got, exact) <= 1.25 * rms(want, exact)


@pytest.mark.parametrize("c", [1, 8])
def test_paged_srf_bf16_matches_reference_kernels(monkeypatch, c):
    """One bf16 state pool through ``_paged_srf``: decode (C=1, the
    srf_decode kernel on f32 copies of the rows, one cast back) and a
    chunk (C=8, bf16 einsums). The updated pool rows match the reference
    bit for bit; so does the decode output. The chunk output rounds its
    bf16 einsums in other places and parts by at most two bf16 spacings
    (rtol=2**-6; 1.3e-2 at most over seeds 0-3)."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "interpret")
    rng = np.random.default_rng(0)
    n, h, m, dv, b = 4, 4, 32, 16, 3
    s = rng.standard_normal((n, h, m, dv)) * 4
    z = rng.random((n, h, m)) * 16
    pq, pk = (rng.random((b, h, c, m)) / 4 for _ in range(2))
    v = rng.standard_normal((b, h, c, dv))
    qv = np.arange(c)[None, :] < np.array([c, max(c - 3, 1), 0])[:, None]
    slots = np.array([1, 3, 0], np.int32)            # row 2: padding
    J = lambda a: jnp.asarray(a, jnp.bfloat16)              # noqa: E731
    P = lambda a: torch.from_numpy(np.array(                 # noqa: E731
        J(a).astype(jnp.float32))).bfloat16()
    jout, jpool = jA._paged_srf(None, {"s": J(s), "z": J(z)},
                                jnp.asarray(slots), J(pq), J(pk), J(v),
                                jnp.asarray(qv))
    pool = {"s": P(s), "z": P(z)}
    out = A._paged_srf(pool, torch.from_numpy(slots).long(), P(pq), P(pk),
                       P(v), torch.from_numpy(qv))
    assert out.dtype == pool["s"].dtype == torch.bfloat16
    f32 = lambda a: np.asarray(a.astype(jnp.float32))       # noqa: E731
    for key in ("s", "z"):                 # slot 0 is the null slot
        np.testing.assert_array_equal(pool[key].float().numpy()[1:],
                                      f32(jpool[key])[1:])
    live = qv.any(axis=1)
    got, want = out.float().numpy()[live], f32(jout)[live]
    if c == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -6,
                                   atol=2 ** -8 * np.abs(want).max())


def test_other_families_raise_not_implemented():
    """Every family resolves to the reference's plan (enc-dec adds its
    memory pool); tensor-parallel cross attention, the last path that
    raised, now runs: per-shard column-parallel wq / wk / wv over a mesh
    axis of two CPU positions, stitched before the replicated wo, equals
    the unsharded cross attention bit for bit (f32)."""
    for arch, over, name in (("seamless-m4t-large-v2",
                              {"attn_impl": "srf"}, "srf+mem"),
                             ("seamless-m4t-large-v2", {}, "kv+mem"),
                             ("qwen2-vl-2b", {"attn_impl": "srf"}, "srf"),
                             ("qwen2-vl-2b", {}, "kv"),
                             ("hymba-1.5b", {}, "kv+ssd"),
                             ("mamba2-2.7b", {}, "ssd"),
                             ("moonshot-v1-16b-a3b", {}, "kv"),
                             ("deepseek-v2-lite-16b", {}, "mla"),
                             ("deepseek-v2-lite-16b", {"attn_impl": "srf"},
                              "srf")):
        assert paged_cache.plan_for(registry.reduced(arch, **over)).name \
            == name == jcache.plan_for(jregistry.reduced(arch, **over)).name
    from repro_torch.distributed import collectives
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serving.mesh import shard
    cfg = registry.reduced("seamless-m4t-large-v2")
    lp = T.init(cfg, seed=0, device="cpu")["segments"][0]
    cross = {k: v[0] for k, v in lp["cross"].items()}
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, cfg.d_model, generator=gen)
    mem = torch.randn(2, 5, cfg.d_model, generator=gen)
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"), device="cpu")
    placed = shard.place_params({"segments": [{"cross": lp["cross"]}]}, cfg,
                                mesh)
    got = A.cross_attention([{k: v[0] for k, v in
                              p["segments"][0]["cross"].items()}
                             for p in placed.parts],
                            shard.local_cfg(cfg, 2), x, mem,
                            tp_axis=collectives.axis_of(mesh, "model"))
    assert torch.equal(got, A.cross_attention(cross, cfg, x, mem))


def _kv_pages(pools, key):
    """Pages 1.. (page 0 is the null page) of the kv pool leaf ``key``,
    all layers, as f32 numpy."""
    a = pools["paged"][0]["attn"][key][:, 1:]
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a.astype(jnp.float32)))


DENSE_CONFIGS = ["qwen2.5-14b", "mistral-nemo-12b", "internlm2-20b"]
KV_CASES = [pytest.param("qwen3-4b", q, id=str(q)) for q in (False, True)] \
    + [pytest.param(a, q, id=f"{a}-{q}") for a in DENSE_CONFIGS
       for q in (False, True)]


@pytest.mark.parametrize("arch,quantize_kv", KV_CASES)
def test_paged_step_kv_logits_match_reference(kv_models, arch, quantize_kv):
    """Full-KV pages (f32, or int8 with f32 row scales) across four pages
    a row: logits within rtol=1e-3; pages equal at the same tolerance
    (f32) or exactly (int8 values and scales; one k or v value that
    lands on the other side of a rounding boundary would show here).
    qwen3-4b and the other dense configs (qwen2.5-14b with nonzero
    q/k/v biases)."""
    jcfg, jparams, cfg, params = kv_models if arch == "qwen3-4b" \
        else _models("full", arch)
    steps = _steps(cfg.vocab)
    want, jpools = _run_jax(jparams, jcfg, steps, quantize_kv)
    got, pools = _run_port(params, cfg, steps, quantize_kv)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    keys = ("k", "v", "k_scale", "v_scale") if quantize_kv else ("k", "v")
    for key in keys:
        g, w = _kv_pages(pools, key), _kv_pages(jpools, key)
        if quantize_kv:
            np.testing.assert_array_equal(g, w) if key in ("k", "v") \
                else np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            np.testing.assert_allclose(g, w, **TOL)


def test_kv_pools_do_not_alias_across_layers(kv_models):
    """Every layer owns its pages: after a prefill step the pages of
    layer 0 and layer 1 differ (an ``expand``-style stacked pool would
    write every layer's KV into one buffer)."""
    _, _, cfg, params = kv_models
    assert cfg.n_layers >= 2
    _, pools = _run_port(params, cfg, _steps(cfg.vocab)[:1])
    for key in ("k", "v"):
        a = pools["paged"][0]["attn"][key]
        assert a.stride(0) == a[0].numel()
        assert a[0, 1].abs().sum() > 0
        assert not torch.equal(a[0, 1:], a[1, 1:])


PAGED_FULL_CASES = [(pool, c) for pool in ("bf16", "int8-bf16", "int8-f32")
                    for c in (1, 8)]


@pytest.mark.parametrize("pool_kind,c", PAGED_FULL_CASES,
                         ids=[f"{p}-C{c}" for p, c in PAGED_FULL_CASES])
def test_paged_full_matches_reference(monkeypatch, pool_kind, c):
    """One layer's full-KV attention on the same pools and chunk: the
    chunk is scattered into its pages, the table width gathered and
    attended. Rows: 8 valid tokens spanning a page boundary, 5 valid of
    8 (the invalid tail lands on the null page in the port and is
    dropped in the reference), and a padding row. Pages 1.. equal
    exactly (bf16 rows are copies; int8 values and scales are the same
    arithmetic). Outputs: one bf16 spacing apart at most where the
    frameworks round f32 softmax weights to bf16 differently (rtol=2**-6,
    atol=2**-8 of the largest value); f32 outputs within 1e-5."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "interpret")
    rng = np.random.default_rng(0)
    cfg = registry.reduced("qwen3-4b")
    n, p, hkv, hq, hd, b = 7, 4, cfg.n_kv_heads, cfg.n_heads, cfg.head_dim, 3
    act = jnp.float32 if pool_kind == "int8-f32" else jnp.bfloat16
    tables = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    start = np.array([2, 0, 0]) if c == 8 else np.array([9, 4, 0])
    pos = (start[:, None] + np.arange(c)[None, :]).astype(np.int32)
    qv = np.arange(c)[None, :] < np.array([c, max(c - 3, 1), 0])[:, None]
    q, k, v = (rng.standard_normal((b, h, c, hd))
               for h in (hq, hkv, hkv))
    if pool_kind == "bf16":
        jpool = {key: jnp.asarray(rng.standard_normal((n, p, hkv, hd)),
                                  jnp.bfloat16) for key in ("k", "v")}
    else:
        jpool = {key: jnp.asarray(rng.integers(-127, 128, (n, p, hkv, hd)),
                                  jnp.int8) for key in ("k", "v")}
        jpool.update({f"{key}_scale": jnp.asarray(
            rng.random((n, p, 1)) / 64, jnp.float32) for key in ("k", "v")})
    J = lambda a: jnp.asarray(a, act)                         # noqa: E731

    def to_torch(a):             # jax -> torch, same dtype and values
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.astype(jnp.float32))
                                    ).bfloat16()
        return torch.from_numpy(np.array(a))
    jout, jnew = jA._paged_full(cfg, J(q), J(k), J(v), jnp.asarray(pos),
                                {"pool": jpool, "tables": jnp.asarray(tables),
                                 "q_valid": jnp.asarray(qv)})
    pool = {key: to_torch(a) for key, a in jpool.items()}
    tq, tk, tv = (to_torch(J(a)) for a in (q, k, v))
    out = A._paged_full(cfg, tq, tk, tv, torch.from_numpy(pos).long(),
                        {"pool": pool, "tables": torch.from_numpy(tables),
                         "q_valid": torch.from_numpy(qv)})
    assert out.dtype == tq.dtype
    f32 = lambda a: (a.float().numpy() if isinstance(a, torch.Tensor)  # noqa
                     else np.asarray(a.astype(jnp.float32)))
    for key in jpool:
        np.testing.assert_array_equal(f32(pool[key])[1:], f32(jnew[key])[1:])
    live = qv.any(axis=1)
    got, want = f32(out)[live], f32(jout)[live]
    if act == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -6,
                                   atol=2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("arch,dtype", [("qwen3-4b", "float32"),
                                        ("qwen3-4b", "bfloat16"),
                                        ("deepseek-v2-lite-16b", "float32")],
                         ids=["full KV f32", "full KV bf16", "MLA f32"])
def test_paged_step_pair_gather_bit_equal_to_two_gathers(arch, dtype,
                                                         monkeypatch):
    """A layer's two pools (K and V; MLA's c and kpe) gathered through one
    ``paged_gather_kv`` give the logits and pools of two single-pool
    gathers, bit for bit, over a chunk and two decode steps."""
    cfg = registry.reduced(arch, dtype=dtype)
    params = T.init(cfg, seed=2, device="cpu")
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    rng = np.random.default_rng(5)

    def run():
        pools = paged_cache.init_pools(cfg, 9, 4, num_slots=4, device="cpu")
        out = []
        for c, start in ((5, 0), (1, 5), (1, 6)):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, c)))
            pos = torch.arange(start, start + c).repeat(2, 1)
            logits, pools = T.paged_step(params, cfg, pools, tok, pos,
                                         torch.ones(2, c, dtype=torch.bool),
                                         tables, torch.tensor([1, 2]))
            out.append(logits)
        return out, pools["paged"]

    rng = np.random.default_rng(5)
    got, got_pools = run()
    monkeypatch.setattr(A, "_paged_hist_kv", lambda a, b, t: (
        A._paged_hist(a, t), A._paged_hist(b, t)))
    rng = np.random.default_rng(5)
    want, want_pools = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got_pools, want_pools):
        for comp in g:
            for k in g[comp]:
                assert torch.equal(g[comp][k], w[comp][k]), (comp, k)

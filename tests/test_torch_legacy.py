"""The port's legacy per-slot engine and the dense prefill / decode modes
against the reference, on the CPU, at reduced size (qwen3-4b, 2 layers,
f32; params converted from the reference's ``T.init`` through
``convert.params_from_jax``; prompts from numpy seeds).

Against the reference:

* ``transformer.prefill`` and ``decode_step`` logits within 2e-5 of the
  largest reference logit (full KV with an f32 and an int8 cache, SRF,
  seeded SRF; measured ~1.5e-6 relative: rope and the softmax round in
  the last ulp);
* ``init_serve_cache`` shapes and dtypes, leaf for leaf (the reference's
  per-layer ``idx`` arrays are one host int per segment in the port);
* ``_quantize_kv``'s int8 values and f32 scales, exactly;
* the legacy engine's tokens over 8 mixed-length requests, greedy and
  sampled (temperature 0.8), for full KV (f32 and int8 cache), SRF and
  seeded SRF: identical;
* ``sampler.sample`` on ``tests/test_paged_serving.py``'s cases and a
  larger grid: identical tokens.

The reference's own contracts, inside the port: paged == legacy, greedy
and sampled (``tests/test_engine_parity.py``), chunked prefill, the
``max_new=1`` and eos-at-prefill cases (``tests/test_paged_serving.py``),
``test_prefill_decode_consistency`` and the int8 cache's quality
(``tests/test_models_smoke.py``). Int8 is held paged == legacy greedy
only: the paged engine quantizes a token over all its heads (one scale
a page row) and the legacy cache per head, so sampled streams part even
in the reference (``CHANGES.md``, PR 20).
"""
import dataclasses
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jA
from repro.models import transformer as jT
from repro.serving import Request as JRequest
from repro.serving import sampler as jsampler
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import seedgen
from repro_torch.launch import steps
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serving import Engine, PagedConfig, Request, SchedConfig
from repro_torch.serving import sampler

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)


def _legacy_modules():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.serving import legacy as jlegacy
        from repro_torch.serving import legacy
    return jlegacy, legacy


def _seeded(cfg):
    return dataclasses.replace(cfg, srf=dataclasses.replace(cfg.srf,
                                                            seeded=True))


# cell -> (config overrides, seeded SRF)
CELLS = {"full": ({}, False), "int8": ({"kv_cache_dtype": "int8"}, False),
         "srf": ({"attn_impl": "srf"}, False),
         "seeded": ({"attn_impl": "srf"}, True)}
_MODELS = {}
# the reference's init, prefill and decode, jitted (cfg static): each
# compiles once per config and shape instead of dispatching op by op
_jinit = jax.jit(jT.init, static_argnums=1)
_jprefill = jax.jit(jT.prefill, static_argnums=1)
_jdecode = jax.jit(jT.decode_step, static_argnums=1)


def _models(cell):
    """(jcfg, jparams, cfg, params) of a cell, built once per module."""
    if cell not in _MODELS:
        over, seeded = CELLS[cell]
        jcfg = jregistry.reduced("qwen3-4b", n_layers=2, **over)
        cfg = registry.reduced("qwen3-4b", n_layers=2, **over)
        if seeded:
            jcfg, cfg = _seeded(jcfg), _seeded(cfg)
        jparams = _jinit(jax.random.PRNGKey(0), jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        _MODELS[cell] = (jcfg, jparams, cfg, params)
    return _MODELS[cell]


def _requests(cls, cfg, n=8, seed=0, temperature=0.0, **kw):
    """test_engine_parity._requests's recipe."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab,
                                           int(rng.integers(2, 20)))
                .astype(np.int32),
                max_new=int(rng.integers(3, 7)), temperature=temperature,
                **kw)
            for i in range(n)]


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    for r in done:
        assert r.t_submit <= r.t_first <= r.t_done, r.uid
    return {r.uid: list(r.out_tokens) for r in done}


# ---------------------------------------------------------------------------
# the model's cache, prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", list(CELLS))
def test_init_serve_cache_shapes_and_dtypes(cell):
    jcfg, _, cfg, _ = _models(cell)
    want = jT.init_serve_cache(jcfg, 3, 24)
    got = T.init_serve_cache(cfg, 3, 24, device="cpu")
    assert got["pos"] == 0 and int(want["pos"]) == 0
    assert len(got["segments"]) == len(want["segments"]) == 1
    jseg, seg = want["segments"][0], got["segments"][0]
    assert set(seg) == set(jseg)
    assert seg["idx"] == 0 and np.asarray(jseg["idx"]).shape == (2,)
    for k in set(seg) - {"idx"}:
        assert tuple(seg[k].shape) == jseg[k].shape, k
        assert str(seg[k].dtype).split(".")[1] == str(jseg[k].dtype), k
        assert not seg[k].any(), k
    if cell == "int8":
        assert seg["k"].dtype == torch.int8
        assert seg["k_scale"].shape[-1] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_exact(dtype):
    x = np.random.default_rng(1).standard_normal((2, 4, 5, 16)) * 3
    x[0, 1, 2] = 0.0                             # an all-zero row: the floor
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jA._quantize_kv(jx)
    q, s = A._quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    back = A._dequantize_kv(q, s, torch.float32).numpy()
    assert np.array_equal(back, np.asarray(jA._dequantize_kv(jq, js,
                                                             jnp.float32)))


@pytest.mark.parametrize("cell", list(CELLS))
def test_prefill_decode_logits_match_reference(cell):
    """Prefill 16 tokens of 2 requests, then 3 decode steps: each step's
    logits within 2e-5 of the reference's largest logit."""
    jcfg, jparams, cfg, params = _models(cell)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 19))
    jcache = jT.init_serve_cache(jcfg, 2, 19)
    cache = T.init_serve_cache(cfg, 2, 19, device="cpu")
    jl, jcache = _jprefill(jparams, jcfg, {"tokens": jnp.asarray(
        toks[:, :16])}, jcache)
    got, cache = T.prefill(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :16])}, cache)
    pairs = [(got, jl)]
    assert cache["pos"] == 16 and cache["segments"][0]["idx"] == 16
    for i in range(3):
        step = toks[:, 16 + i:17 + i]
        jl, jcache = _jdecode(jparams, jcfg, jcache, jnp.asarray(step))
        got, cache = T.decode_step(params, cfg, cache, torch.from_numpy(step))
        pairs.append((got, jl))
    assert cache["pos"] == 19 and cache["segments"][0]["idx"] == 19
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape == (2, 1, cfg.padded_vocab)
        err = np.abs(got.numpy() - want).max()
        assert err <= 2e-5 * np.abs(want).max(), (cell, err)


def test_srf_state_cast_to_v_dtype_and_decoded_in_its_own():
    """bf16 SRF (the full-width dtype): prefill stores the state in v's
    dtype, decode keeps it there (the reference's rounding, not the paged
    path's f32 update), and the logits follow the reference's within
    bf16's tolerance."""
    jcfg = jregistry.reduced("qwen3-4b", n_layers=2, attn_impl="srf",
                             dtype="bfloat16")
    cfg = registry.reduced("qwen3-4b", n_layers=2, attn_impl="srf",
                           dtype="bfloat16")
    jparams = _jinit(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 12))
    jcache = jT.init_serve_cache(jcfg, 2, 12)
    cache = T.init_serve_cache(cfg, 2, 12, device="cpu")
    jl, jcache = _jprefill(jparams, jcfg, {"tokens": jnp.asarray(
        toks[:, :10])}, jcache)
    got, cache = T.prefill(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :10])}, cache)
    for _ in range(2):
        nxt = toks[:, 10 + _:11 + _]
        jl, jcache = _jdecode(jparams, jcfg, jcache, jnp.asarray(nxt))
        got, cache = T.decode_step(params, cfg, cache, torch.from_numpy(nxt))
    seg = cache["segments"][0]
    assert seg["s"].dtype == seg["z"].dtype == torch.bfloat16
    assert jcache["segments"][0]["s"].dtype == jnp.bfloat16
    want = np.asarray(jl.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 3e-2 * np.abs(want).max(), err


def test_make_serve_step_is_greedy_over_the_vocab():
    _, _, cfg, params = _models("full")
    cache = T.init_serve_cache(cfg, 2, 16, device="cpu")
    prefill = steps.make_prefill_step(cfg)
    serve_step = steps.make_serve_step(cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 6)))
    _, cache = prefill(params, {"tokens": toks}, cache)
    nxt, logits, cache = serve_step(params, cache, toks[:, -1:])
    assert logits.shape == (2, cfg.vocab) and nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], logits.argmax(-1))
    assert cache["pos"] == 7


# ---------------------------------------------------------------------------
# the sampler's batch-wide key
# ---------------------------------------------------------------------------

def _w(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_sample_matches_reference_on_paged_serving_cases():
    """tests/test_paged_serving.py's sampler cases, token for token: the
    greedy / k=1 / tiny-p rows, and the top-k=2 support over 64 keys."""
    lg = np.log(np.asarray([[0.05, 0.15, 0.5, 0.3]] * 3, np.float32))
    out = sampler.sample(_w(jax.random.PRNGKey(0)), torch.from_numpy(lg),
                         np.array([0.0, 1.0, 1.0], np.float32),
                         np.array([0, 1, 0]),
                         np.array([1.0, 1.0, 1e-6], np.float32))
    assert out.tolist() == [2, 2, 2]
    hits = set()
    for i in range(64):
        key = jax.random.PRNGKey(i)
        want = jsampler.sample(key, jnp.asarray(lg), jnp.asarray([1.0] * 3),
                               jnp.asarray([2] * 3), jnp.asarray([1.0] * 3))
        got = sampler.sample(_w(key), torch.from_numpy(lg), [1.0] * 3,
                             [2] * 3, [1.0] * 3)
        assert got.tolist() == np.asarray(want).tolist(), i
        hits.update(got.tolist())
    assert hits == {2, 3}


def test_sample_matches_reference_on_a_grid():
    """8 rows x 384 logits a call, mixed temperature / top-k / top-p and
    greedy rows, 8 keys: the noise's counters run over the flattened
    (B, V) grid, as jax.random.gumbel(key, (B, V)) draws them."""
    rng = np.random.default_rng(2)
    for call in range(8):
        lg = (rng.standard_normal((8, 384)) * 3).astype(np.float32)
        temps = np.array([0.0, 0.5, 1.0, 1.7] * 2, np.float32)
        ks = np.array([0, 1, 7, 0, 40, 0, 3, 0], np.int32)
        ps = np.array([1.0, 0.9, 0.3, 1.0, 0.95, 1.0, 1.0, 0.5], np.float32)
        key = jax.random.PRNGKey(100 + call)
        want = jsampler.sample(key, jnp.asarray(lg), jnp.asarray(temps),
                               jnp.asarray(ks), jnp.asarray(ps))
        got = sampler.sample(seedgen.threefry_seed(100 + call),
                             torch.from_numpy(lg), temps, ks, ps)
        assert got.tolist() == np.asarray(want).tolist(), call


# ---------------------------------------------------------------------------
# the legacy engine against the reference's
# ---------------------------------------------------------------------------

_ref_jits = {}


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy",
                                                          "sampled"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_legacy_tokens_match_reference(cell, temperature):
    jlegacy, legacy = _legacy_modules()
    jcfg, jparams, cfg, params = _models(cell)
    jeng = jlegacy.Engine(jcfg, jparams, batch_slots=4, max_len=64, seed=5)
    # the reference wraps its prefill and decode in a new jax.jit per
    # engine (a compile per prompt length): a cell's greedy and sampled
    # engines share the first one's
    jeng._prefill, jeng._step = _ref_jits.setdefault(
        jcfg, (jeng._prefill, jeng._step))
    want = _drive(jeng, _requests(JRequest, jcfg, temperature=temperature))
    eng = legacy.Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                        device="cpu")
    got = _drive(eng, _requests(Request, cfg, temperature=temperature))
    assert len(got) == 8 and got == want
    assert eng.nonfinite_rows == 0
    assert eng.stats["requests"] == 8
    assert eng.stats["tokens"] == sum(map(len, got.values()))


# ---------------------------------------------------------------------------
# the reference's contracts inside the port
# ---------------------------------------------------------------------------

PARITY = [(cell, t) for cell in CELLS for t in (0.0, 0.8)
          if not (cell == "int8" and t > 0)]


@pytest.mark.parametrize("cell,temperature", PARITY,
                         ids=[f"{c}-{'sampled' if t else 'greedy'}"
                              for c, t in PARITY])
def test_paged_equals_legacy(cell, temperature):
    """test_engine_parity.py's greedy and sampled cells: the port's paged
    engine gives the port's legacy engine's tokens (int8: int8 pages
    against the int8 cache, greedy)."""
    _, legacy = _legacy_modules()
    _, _, cfg, params = _models(cell)
    paged = _drive(Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                          device="cpu",
                          paged=PagedConfig(quantize_kv=cell == "int8")),
                   _requests(Request, cfg, temperature=temperature))
    old = _drive(legacy.Engine(cfg, params, batch_slots=4, max_len=64,
                               seed=5, device="cpu"),
                 _requests(Request, cfg, temperature=temperature))
    assert len(paged) == 8 and paged == old


@pytest.mark.parametrize("attn", ["full", "srf"])
def test_chunked_prefill_long_prompt(attn):
    """A 50-token prompt prefilled in chunks of 8 by the paged engine
    gives the tokens of one legacy prefill."""
    _, legacy = _legacy_modules()
    _, _, cfg, params = _models(attn)
    prompt = (np.arange(50, dtype=np.int32) * 7) % cfg.vocab
    sched = SchedConfig(max_batch=2, prefill_batch=2, prefill_chunk=8,
                        page_size=8, num_pages=33, table_width=8)
    eng = Engine(cfg, params, sched=sched, device="cpu")
    eng.submit(Request(uid=0, prompt=prompt, max_new=6))
    paged = eng.run()[0].out_tokens
    leg = legacy.Engine(cfg, params, batch_slots=1, max_len=128,
                        device="cpu")
    leg.submit(Request(uid=0, prompt=prompt, max_new=6))
    assert paged == leg.run()[0].out_tokens


def test_max_new_one_emits_exactly_one_token():
    _, legacy = _legacy_modules()
    _, _, cfg, params = _models("full")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(2, 12)))
               .astype(np.int32) for _ in range(6)]
    eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    leg = legacy.Engine(cfg, params, batch_slots=4, max_len=64,
                        device="cpu")
    for e in (eng, leg):
        for i, p in enumerate(prompts):
            e.submit(Request(uid=i, prompt=p.copy(), max_new=1))
    done, ldone = eng.run(), leg.run()
    assert len(done) == len(ldone) == 6
    assert all(len(r.out_tokens) == 1 for r in done + ldone)
    assert eng.metrics.value_sum("engine_decode_steps_total") == 0
    assert all(a is None for a in leg.active)
    assert {r.uid: r.out_tokens for r in done} == \
        {r.uid: r.out_tokens for r in ldone}


def test_eos_on_first_token_finishes_at_prefill():
    """Both engines stop a request whose first token is its eos with that
    one token; the paged engine's trace closes."""
    _, legacy = _legacy_modules()
    _, _, cfg, params = _models("full")
    prompt = np.arange(9, dtype=np.int32)
    leg = legacy.Engine(cfg, params, batch_slots=2, max_len=64, device="cpu")
    leg.submit(Request(uid=0, prompt=prompt.copy(), max_new=8))
    first = leg.run()[0].out_tokens[0]
    for eng in (Engine(cfg, params, batch_slots=2, max_len=64, device="cpu"),
                legacy.Engine(cfg, params, batch_slots=2, max_len=64,
                              device="cpu")):
        eng.submit(Request(uid=0, prompt=prompt.copy(), max_new=8,
                           eos_id=int(first)))
        (r,) = eng.run()
        assert r.out_tokens == [first]
        assert r.t_submit <= r.t_first <= r.t_done
        if r.trace is not None:
            assert r.trace.count("done") == 1 and r.trace.monotonic()
            assert eng.metrics.value_sum("engine_decode_steps_total") == 0


@pytest.mark.parametrize("arch", ["qwen3-4b", "mistral-nemo-12b",
                                  "qwen2.5-14b", "internlm2-20b"])
def test_prefill_decode_consistency(arch):
    """test_models_smoke.py's check on the port's dense archs: prefill and
    decode logits equal the training forward's within 2e-4 of its
    largest logit (qwen2.5-14b with nonzero q/k/v biases)."""
    cfg = registry.reduced(arch)
    params = T.init(cfg, seed=0, device="cpu")
    if cfg.qkv_bias:     # init makes them zeros: perturb, as a trained
        gen = torch.Generator().manual_seed(7)    # model's are not
        attn = params["segments"][0]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = torch.randn(attn[name].shape, generator=gen) * 0.1
    b, p, n = 2, 16, 3
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, p + n)))
    full, _ = T.forward(params, cfg, {"tokens": toks})
    cache = T.init_serve_cache(cfg, b, p + n, device="cpu")
    lp, cache = T.prefill(params, cfg, {"tokens": toks[:, :p]}, cache)
    scale = float(full.abs().max())
    errs = [float((lp[:, 0] - full[:, p - 1]).abs().max())]
    for i in range(n):
        ld, cache = T.decode_step(params, cfg, cache, toks[:, p + i:p + i + 1])
        errs.append(float((ld[:, 0] - full[:, p + i]).abs().max()))
    assert max(errs) / scale < 2e-4, (arch, errs)


def test_int8_kv_cache_decode_quality():
    """test_models_smoke.py's int8 check: the int8 cache's logits stay
    within 5% of the params'-dtype cache's and the greedy tokens match."""
    outs = {}
    for kvd in ("bf16", "int8"):
        cfg = registry.reduced("qwen3-4b", kv_cache_dtype=kvd)
        params = T.init(cfg, seed=0, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (2, 20)))
        cache = T.init_serve_cache(cfg, 2, 24, device="cpu")
        if kvd == "int8":
            assert cache["segments"][0]["k"].dtype == torch.int8
        lp, cache = T.prefill(params, cfg, {"tokens": toks[:, :16]}, cache)
        ls = [lp]
        for i in range(4):
            ld, cache = T.decode_step(params, cfg, cache,
                                      toks[:, 16 + i:17 + i])
            ls.append(ld)
        outs[kvd] = torch.cat(ls, dim=1)
    scale = float(outs["bf16"].abs().max())
    assert float((outs["bf16"] - outs["int8"]).abs().max()) / scale < 0.05
    assert torch.equal(outs["bf16"].argmax(-1), outs["int8"].argmax(-1))


def test_decode_write_clamps_past_the_end():
    """A decode past max_len writes the last row, as the reference's
    dynamic_update_slice clamps (no index error)."""
    _, _, cfg, params = _models("full")
    cache = T.init_serve_cache(cfg, 1, 4, device="cpu")
    toks = torch.arange(4)[None]
    _, cache = T.prefill(params, cfg, {"tokens": toks}, cache)
    logits, cache = T.decode_step(params, cfg, cache, toks[:, :1])
    assert cache["pos"] == 5 and torch.isfinite(logits).all()


def test_cached_modes_need_a_cache():
    _, _, cfg, params = _models("full")
    lp = T.tree_index(params["segments"][0], 0)
    x = torch.zeros(1, 3, cfg.d_model)
    for mode in ("prefill", "decode"):
        with pytest.raises(ValueError, match="needs a cache"):
            A.attention(lp["attn"], cfg, x, torch.arange(3)[None], mode)


def test_legacy_import_warns_deprecation():
    """Importing the legacy module warns, as the reference's does (the
    port's message, which pytest.ini's error filter for the reference's
    does not match)."""
    _, legacy = _legacy_modules()
    with pytest.warns(DeprecationWarning,
                      match=r"^repro_torch\.serving\.legacy is deprecated"):
        importlib.reload(legacy)

"""Seeded (zero-storage) spinner and seeded SRF of the port against the
reference, on the CPU.

Inputs are made with numpy and handed to both packages. Tolerances:

* exact (``torch.equal`` against ``np.asarray`` of the reference): the
  threefry2x32 streams, ``fold_seed``, ``sign_at``, ``uniform_bits_at``,
  the ldr ``h`` support and signs, and the HD diagonals;
* normals within 2e-6 absolute: torch's and XLA's f32 ``log`` and ``cos``
  differ in the last ulp (max 4.8e-7 over 10**5 positions);
* ``spinner_project_seeded`` in f32 within 1e-4 of the largest value
  (FFT, Kronecker and in-kernel sum orders differ, plus the normals'
  ulps), in bf16 within one bf16 spacing (rtol 2**-7) of the reference's
  Pallas kernel in interpret mode: both compute in f32 and round once;
* inside the port the seeded spinner equals the materialized one on the
  regenerated params bit for bit;
* feature maps within rtol 1e-3 (as ``test_torch_core``), engines' greedy
  and sampled tokens identical.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import spinner as jspinner
from repro.core import srf_attention as jsrf
from repro.kernels import ops as jops
from repro.kernels import seedgen as jseedgen
from repro.models import transformer as jT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import spinner, srf_attention
from repro_torch.kernels import ops, seedgen
from repro_torch.kernels import spinner as kspin
from repro_torch.serving import Engine, Request

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

KERNEL_KINDS = ("circulant", "skew_circulant", "toeplitz", "hankel",
                "unstructured")
G, B, N, M = 3, 5, 16, 40


def _w(a) -> torch.Tensor:
    """uint32 numpy -> the port's int64 words."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _seeds(g, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2 ** 32, g, dtype=np.uint64).astype(np.uint32)
    s[0] = 0xFFFFFFFF
    return s


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def test_threefry_bit_exact():
    rng = np.random.default_rng(0)
    c0 = rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64).astype(np.uint32)
    c1 = rng.integers(0, 2 ** 32, 100_000, dtype=np.uint64).astype(np.uint32)
    c0[:4] = [0, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    c1[:4] = [0, 0xFFFFFFFF, 0xFFFFFFFF, 0]
    for k0, k1 in ((0, 0), (0xFFFFFFFF, 7), (123456789, 0xFFFFFFFF)):
        want = jseedgen.threefry2x32(k0, k1, jnp.asarray(c0),
                                     jnp.asarray(c1))
        got = seedgen.threefry2x32(k0, k1, _w(c0), _w(c1))
        for g, w in zip(got, want):
            assert torch.equal(g, _w(w))


def test_integer_streams_bit_exact():
    pos = np.arange(4096, dtype=np.int32)
    seeds = _seeds(4, seed=1)
    for s in seeds:
        for dom in (seedgen.DOM_D0, seedgen.DOM_H_SGN):
            assert torch.equal(
                seedgen.sign_at(int(s), dom, torch.from_numpy(pos)
                                .long()),
                torch.from_numpy(np.array(jseedgen.sign_at(
                    s, dom, jnp.asarray(pos)))))
        assert torch.equal(
            seedgen.uniform_bits_at(int(s), seedgen.DOM_H_IDX,
                                    torch.from_numpy(pos).long()),
            _w(jseedgen.uniform_bits_at(s, seedgen.DOM_H_IDX,
                                        jnp.asarray(pos))))
    data = _seeds(7, seed=2)
    assert torch.equal(
        seedgen.fold_seed(_w(seeds)[:, None], _w(data)[None, :]),
        _w(jseedgen.fold_seed(jnp.asarray(seeds)[:, None],
                              jnp.asarray(data)[None, :])))


def test_normals_within_ulps():
    pos = np.arange(100_000, dtype=np.int32)
    for s in _seeds(3, seed=3):
        got = seedgen.normal_at(int(s), seedgen.DOM_G,
                                torch.from_numpy(pos).long())
        want = np.asarray(jseedgen.normal_at(s, seedgen.DOM_G,
                                             jnp.asarray(pos)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("kind", KERNEL_KINDS + ("ldr",))
def test_grouped_params_match_reference(kind):
    """Every leaf of ``grouped_params``: integer-valued leaves (signs, the
    ldr h support and signs) exactly, generators within 2e-6."""
    seeds = _seeds(G, seed=4)
    got = seedgen.grouped_params(kind, N, M, _w(seeds), r=2, ldr_nnz=3)
    want = jseedgen.grouped_params(kind, N, M, jnp.asarray(seeds), r=2,
                                   ldr_nnz=3)
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.array(w)
        assert tuple(got[name].shape) == w.shape
        if name == "g":
            np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                       atol=2e-6)
        else:
            assert torch.equal(got[name], torch.from_numpy(w)), name
    one = seedgen.seeded_params(kind, N, M, int(seeds[1]), r=2, ldr_nnz=3)
    for name, t in one.items():
        assert torch.equal(t, got[name][1])


def test_gen_tile_matches_seeded_params():
    """The tile rule the kernel's windows follow: every A[i, j] equals the
    dense matrix of the regenerated params."""
    from repro_torch.core import structured
    for kind in KERNEL_KINDS:
        p = seedgen.seeded_params(kind, N, M, 99, use_hd=False)
        dense = structured.materialize(kind, p, M, N)
        rows, cols = torch.meshgrid(torch.arange(M), torch.arange(N),
                                    indexing="ij")
        nb = -(-M // N)
        tile = seedgen.gen_tile(kind, 99, rows, cols, n=N, m=M, nb=nb)
        assert torch.equal(tile, dense), kind


# ---------------------------------------------------------------------------
# the seeded spinner
# ---------------------------------------------------------------------------

CASES = [(kind, epi, grouped) for kind in KERNEL_KINDS
         for epi in ("identity", "exp", "cos_sin")
         for grouped in (True, False)]


def _x(g, seed=5, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g, B, N)) * N ** -0.25).astype(dtype)


def _port(kind, seeds, x, epi, grouped, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype)
    s = _w(seeds)
    if not grouped:
        xt, s = xt[0], s[0]
    return ops.spinner_project_seeded(kind, s, xt, M, epilogue=epi,
                                      y_scale=0.8, out_scale=M ** -0.5,
                                      grouped=grouped)


def _ref(kind, seeds, x, epi, grouped, use_pallas, dtype=jnp.float32):
    xj = jnp.asarray(x, dtype)
    s = jnp.asarray(seeds)
    if not grouped:
        xj, s = xj[0], s[0]
    return jops.spinner_project_seeded(kind, s, xj, M, epilogue=epi,
                                       y_scale=0.8, out_scale=M ** -0.5,
                                       grouped=grouped,
                                       use_pallas=use_pallas)


@pytest.mark.parametrize("kind,epi,grouped", CASES)
def test_seeded_spinner_f32_matches_reference(kind, epi, grouped):
    """Against the reference's Pallas kernel in interpret mode and its
    jnp route, within 1e-4 of the largest value; and bit for bit against
    the port's own materialized spinner on the regenerated params."""
    seeds, x = _seeds(G, seed=6), _x(G)
    got = _port(kind, seeds, x, epi, grouped)
    for use_pallas in (True, False):
        want = np.asarray(_ref(kind, seeds, x, epi, grouped, use_pallas))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    params = seedgen.grouped_params(kind, N, M, _w(seeds))
    if not grouped:
        params = {k: v[0] for k, v in params.items()}
        x = x[0]
    twin = ops.spinner_project(kind, params, torch.from_numpy(x), M,
                               epilogue=epi, y_scale=0.8,
                               out_scale=M ** -0.5, grouped=grouped)
    assert torch.equal(got, twin)


@pytest.mark.parametrize("kind,epi,grouped", CASES)
def test_seeded_spinner_bf16_matches_pallas(monkeypatch, kind, epi,
                                            grouped):
    """bf16 x: within one bf16 spacing of the reference's Pallas kernel
    in interpret mode (the TPU kernel's numerics: f32 until one cast)."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "interpret")
    seeds = _seeds(G, seed=7)
    x = np.array(jnp.asarray(_x(G, seed=8), jnp.bfloat16)
                 .astype(jnp.float32))
    got = _port(kind, seeds, x, epi, grouped, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = _ref(kind, seeds, x, epi, grouped, None, dtype=jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_seeded_ldr_takes_the_plain_route():
    """ldr is not a kernel kind: on either device it takes the plain
    version (counted on the card); here it matches the reference's."""
    seeds, x = _seeds(G, seed=9), _x(G)
    got = _port("ldr", seeds, x, "identity", True)
    want = np.asarray(_ref("ldr", seeds, x, "identity", True, None))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert not ops.kernel_takes("ldr", N, M, True)


def test_seeded_block_config_and_storage():
    """``SpinnerBlock(seeded=True)``: storage 1, the same JSON as the
    reference both ways, params one seed, materialize = the dense block
    of the regenerated params."""
    jpipe = jspinner.hd_chain("toeplitz", n=16, m=24, depth=2, seeded=True,
                              f="exp")
    s = jspinner.dumps(jpipe)
    pipe = spinner.loads(s)
    assert spinner.dumps(pipe) == s and json.loads(s)["blocks"][0]["seeded"]
    assert jspinner.loads(spinner.dumps(pipe)) == jpipe
    assert all(b.seeded and b.storage == 1 for b in pipe.blocks)
    assert pipe.storage == jpipe.storage == 2
    params = pipe.init(torch.Generator().manual_seed(0))
    assert [set(p) for p in params] == [{"seed"}, {"seed"}]
    assert all(p["seed"].dtype == torch.int64 and p["seed"].dim() == 0
               and 0 <= int(p["seed"]) < 2 ** 31 for p in params)
    blk, p = pipe.blocks[-1], params[-1]
    mat = spinner.SpinnerBlock("toeplitz", 24, 16)
    assert torch.equal(blk.materialize(p),
                       mat.materialize(blk._oracle_params(p)))


def test_seeded_pipeline_apply_matches_reference():
    jpipe = jspinner.single("circulant", 24, 16, seeded=True, f="relu")
    pipe = spinner.single("circulant", 24, 16, seeded=True, f="relu")
    x = _x(1, seed=10)[0]
    seed = np.uint32(0xDEADBEEF)
    got = pipe.apply(({"seed": torch.tensor(int(seed))},),
                     torch.from_numpy(x))
    want = np.asarray(jpipe.apply(({"seed": jnp.asarray(seed)},),
                                  jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("feature", ["softmax_pos", "trig"])
def test_feature_map_embed_seeds_matches_reference(feature):
    """(head, request)-major groups with folded per-request seeds; embed
    seed 0 passes the head seed through (equal to no embed seeds)."""
    jcfg = jsrf.SRFConfig(n_features=24, head_dim=16, feature=feature,
                          seeded=True)
    cfg = srf_attention.SRFConfig(n_features=24, head_dim=16,
                                  feature=feature, seeded=True)
    params = jsrf.init(jax.random.PRNGKey(0), jcfg, 2)
    tp = tuple({"seed": _w(p["seed"])} for p in params)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 2, 5, 16)).astype(np.float32)
    es = np.array([0, 123, 0xFFFFFFFF], np.uint32)
    for is_q in (True, False):
        got = srf_attention.feature_map(cfg, tp, torch.from_numpy(x), is_q,
                                        embed_seeds=_w(es))
        want = jsrf.feature_map(jcfg, params, jnp.asarray(x), is_q,
                                embed_seeds=jnp.asarray(es))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-4)
        base = srf_attention.feature_map(cfg, tp, torch.from_numpy(x), is_q)
        torch.testing.assert_close(got[0], base[0], rtol=0, atol=1e-6)
        for i in (1, 2):
            assert not torch.allclose(got[i], base[i])
    folded = srf_attention.fold_embed(tp, _w(es))
    want_fold = jsrf._fold_embed(params, jnp.asarray(es), 2)
    assert torch.equal(folded[0]["seed"], _w(want_fold[0]["seed"]))
    with pytest.raises(ValueError, match="seeded"):
        srf_attention.feature_map(dataclasses.replace(cfg, seeded=False),
                                  tp, torch.from_numpy(x), True,
                                  embed_seeds=_w(es))


# ---------------------------------------------------------------------------
# seeded SRF served by the engine
# ---------------------------------------------------------------------------

def _seeded(cfg):
    return dataclasses.replace(cfg, srf=dataclasses.replace(cfg.srf,
                                                            seeded=True))


@pytest.fixture(scope="module")
def seeded_models():
    jcfg = _seeded(jregistry.reduced("qwen3-4b", n_layers=2,
                                     attn_impl="srf"))
    cfg = _seeded(registry.reduced("qwen3-4b", n_layers=2, attn_impl="srf"))
    jparams = jT.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return jcfg, jparams, cfg, params


def _requests(cls, cfg, n=8, seed=0, sampled=True):
    """test_engine_parity._requests's recipe, with embed seeds (0 on
    every third request) and, if ``sampled``, every other request at
    temperature > 0 with top-k / top-p."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(2, 20)))
        kw = {}
        if sampled and i % 2:
            kw = dict(temperature=(0.7, 1.1)[i % 4 == 1],
                      top_k=(0, 40)[i % 3 == 0], top_p=(1.0, 0.9)[i % 5 == 1])
        out.append(cls(uid=i, prompt=prompt.astype(np.int32),
                       max_new=int(rng.integers(3, 7)),
                       embed_seed=0 if i % 3 == 0 else 1000 * i + 7, **kw))
    return out


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: list(r.out_tokens) for r in eng.run()}


def test_convert_carries_seeds(seeded_models):
    """uint32 (layers, kv heads) seed leaves become int64 words with the
    same values; no float projection leaf exists."""
    jcfg, jparams, cfg, params = seeded_models
    jsrf_p = jparams["segments"][0]["attn"]["srf"]
    got = params["segments"][0]["attn"]["srf"]
    assert len(got) == len(jsrf_p) == 1 and set(got[0]) == {"seed"}
    assert got[0]["seed"].dtype == torch.int64
    assert got[0]["seed"].shape == (cfg.n_layers, cfg.n_kv_heads)
    assert torch.equal(got[0]["seed"], _w(jsrf_p[0]["seed"]))


def test_seeded_engine_tokens_identical_to_reference(seeded_models):
    """Mixed embed seeds and mixed greedy / sampled requests (engine seed
    3): the port's tokens equal the reference engine's."""
    jcfg, jparams, cfg, params = seeded_models
    want = _drive(JEngine(jcfg, jparams, batch_slots=4, max_len=64, seed=3),
                  _requests(JRequest, jcfg))
    eng = Engine(cfg, params, batch_slots=4, max_len=64, seed=3,
                 device="cpu")
    got = _drive(eng, _requests(Request, cfg))
    assert len(got) == 8 and got == want
    assert eng.nonfinite_rows == 0 and eng.free_slots == eng.usable_slots


def test_seeded_srf_engine_personalizes_per_request(seeded_models):
    """Port of the reference's test: same prompt, different embed seeds
    -> different greedy streams; each stream reproduces solo and on a
    rerun."""
    _, _, cfg, params = seeded_models
    prompt = np.arange(9, dtype=np.int32)

    def run(seeds):
        eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
        for i, es in enumerate(seeds):
            eng.submit(Request(uid=i, prompt=prompt.copy(), max_new=6,
                               embed_seed=es))
        return _drive(eng, [])

    mixed = run([0, 123, 777])
    assert mixed[1] != mixed[0] and mixed[2] != mixed[1]
    assert run([123])[0] == mixed[1]
    assert run([0])[0] == mixed[0]
    assert run([0, 123, 777]) == mixed


def test_seeded_srf_zero_embed_matches_unseeded_semantics(seeded_models):
    """Port of the reference's test: an all-base batch (embed_seed=0
    given) equals the same batch with the field left at its default."""
    _, _, cfg, params = seeded_models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 14)))
               .astype(np.int32) for _ in range(5)]

    def run(with_field):
        eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
        for i, p in enumerate(prompts):
            kw = {"embed_seed": 0} if with_field else {}
            eng.submit(Request(uid=i, prompt=p.copy(), max_new=5, **kw))
        return _drive(eng, [])

    assert run(True) == run(False)


def test_seeded_steps_pass_embed_seeds_every_step(seeded_models,
                                                  monkeypatch):
    """A seeded engine passes (B,) embed seeds on every step, all-zero
    batches included, as the reference does; (head, request) groups then
    reach the seeded spinner."""
    from repro_torch.models import transformer as T
    _, _, cfg, params = seeded_models
    seen = []
    real = T.paged_step

    def spy(*a, embed_seeds=None, **kw):
        seen.append(None if embed_seeds is None else embed_seeds.tolist())
        return real(*a, embed_seeds=embed_seeds, **kw)

    monkeypatch.setattr(T, "paged_step", spy)
    eng = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu")
    _drive(eng, [Request(uid=0, prompt=np.arange(5, dtype=np.int32),
                         max_new=3),
                 Request(uid=1, prompt=np.arange(4, dtype=np.int32),
                         max_new=3, embed_seed=2 ** 32 + 5)])
    assert seen and all(s is not None and len(s) == 2 for s in seen)
    assert [0, 5] in seen


def test_seeded_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kspin.spinner_project_seeded_cuda(
            "circulant", torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, 2, 8), 16)

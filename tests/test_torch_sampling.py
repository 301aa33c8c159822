"""The port's stateless sampler and sampled serving against the reference,
on the CPU.

Exact (``torch.equal`` against ``np.asarray`` of the reference): the raw
keys of ``jax.random.PRNGKey``, the folded per-row keys
``fold_in(fold_in(base, uid), position)`` and their 32-bit random bits.
Within 1e-6 absolute (relative for large values): the Gumbel noise,
whose ``log`` torch and XLA round differently in the last ulp. Tokens:
identical, for the sampler over a grid of temperature / top-k / top-p
(greedy rows included), and for reduced qwen3-4b served by both engines
with full-KV pages and sampled rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving import sampler as jsampler
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import seedgen
from repro_torch.launch import serve
from repro_torch.serving import Engine, Request, sampler

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)


def _w(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 2 ** 32 - 1])
def test_base_key_and_folded_keys_bit_exact(seed):
    rng = np.random.default_rng(seed % 1000)
    uids = rng.integers(0, 2 ** 32, 16, dtype=np.uint64).astype(np.uint32)
    uids[:2] = [0, 0xFFFFFFFF]
    pos = rng.integers(0, 4096, 16).astype(np.int32)
    base = jax.random.PRNGKey(seed)
    assert torch.equal(seedgen.threefry_seed(seed), _w(base))
    want = jax.vmap(lambda u, p: jax.random.fold_in(
        jax.random.fold_in(base, u), p))(jnp.asarray(uids), jnp.asarray(pos))
    keys = sampler.row_keys(seedgen.threefry_seed(seed), _w(uids), _w(pos))
    assert torch.equal(keys, _w(want))
    bits = jax.vmap(lambda k: jax.random.bits(k, (1000,), jnp.uint32))(want)
    assert torch.equal(seedgen.random_bits(keys, 1000), _w(bits))
    g = jax.vmap(lambda k: jax.random.gumbel(k, (1000,), jnp.float32))(want)
    np.testing.assert_allclose(seedgen.gumbel(keys, 1000).numpy(),
                               np.asarray(g), rtol=1e-6, atol=1e-6)


GRID = [(t, k, p) for t in (0.0, 0.5, 1.0, 1.7) for k in (0, 1, 7)
        for p in (1.0, 0.9, 0.3)]


def test_sample_stateless_tokens_match_reference():
    """8 rows a call, each row one (temperature, top_k, top_p) of the
    grid (greedy rows among them), over 12 calls with fresh logits, uids
    and positions: the same tokens as the reference."""
    rng = np.random.default_rng(0)
    v = 384
    for call in range(12):
        rows = [GRID[(call * 8 + i) % len(GRID)] for i in range(8)]
        temps = np.array([r[0] for r in rows], np.float32)
        ks = np.array([r[1] for r in rows], np.int32)
        ps = np.array([r[2] for r in rows], np.float32)
        logits = (rng.standard_normal((8, v)) * 3).astype(np.float32)
        uids = rng.integers(0, 2 ** 32, 8, dtype=np.uint64).astype(np.uint32)
        pos = rng.integers(0, 64, 8).astype(np.int32)
        want = jsampler.sample_stateless(
            jax.random.PRNGKey(call), jnp.asarray(uids), jnp.asarray(pos),
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(ks),
            jnp.asarray(ps))
        got = sampler.sample_stateless(
            seedgen.threefry_seed(call), uids.astype(np.int64),
            pos.astype(np.int64), torch.from_numpy(logits), temps, ks, ps)
        assert got.tolist() == np.asarray(want).tolist(), call
        greedy = temps <= 0
        assert (got.numpy()[greedy] == logits.argmax(-1)[greedy]).all()


def test_all_greedy_batch_is_argmax():
    logits = torch.randn(5, 50, generator=torch.Generator().manual_seed(0))
    got = sampler.sample_stateless(seedgen.threefry_seed(0), np.arange(5),
                                   np.zeros(5), logits, np.zeros(5),
                                   np.zeros(5), np.ones(5))
    assert torch.equal(got, torch.argmax(logits, -1))


# ---------------------------------------------------------------------------
# sampled serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kv_models():
    jcfg = jregistry.reduced("qwen3-4b", n_layers=2)
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    jparams = jT.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return jcfg, jparams, cfg, params


def _requests(cls, cfg, n=8, seed=0, temperature=0.9):
    """test_engine_parity._requests's recipe; every other request sampled
    (its own temperature, top-k and top-p), the rest greedy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(2, 20)))
        kw = {}
        if i % 2:
            kw = dict(temperature=temperature * (1 + 0.2 * (i % 3)),
                      top_k=(0, 40, 5)[i % 3], top_p=(1.0, 0.95)[i % 4 == 1])
        out.append(cls(uid=i, prompt=prompt.astype(np.int32),
                       max_new=int(rng.integers(3, 7)), **kw))
    return out


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: list(r.out_tokens) for r in eng.run()}


def test_kv_sampled_tokens_identical_to_reference(kv_models):
    """Full-KV pages, mixed greedy and sampled requests, engine seed 5:
    the port's tokens equal the reference engine's."""
    jcfg, jparams, cfg, params = kv_models
    want = _drive(JEngine(jcfg, jparams, batch_slots=4, max_len=64, seed=5),
                  _requests(JRequest, jcfg))
    eng = Engine(cfg, params, batch_slots=4, max_len=64, seed=5,
                 device="cpu")
    got = _drive(eng, _requests(Request, cfg))
    assert len(got) == 8 and got == want and eng.nonfinite_rows == 0


def test_seeded_sampling_deterministic(kv_models):
    """Port of the reference's test: engine seed 7 twice gives the same
    sampled tokens, seed 8 other tokens."""
    _, _, cfg, params = kv_models

    def run(seed):
        return _drive(Engine(cfg, params, batch_slots=4, max_len=64,
                             seed=seed, device="cpu"),
                      [Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                               temperature=0.9)
                       for r in _requests(Request, cfg)])
    a, b, c = run(7), run(7), run(8)
    assert len(a) == 8 and a == b
    assert all(0 <= t < cfg.vocab for toks in a.values() for t in toks)
    assert c != a


def test_sampled_stream_independent_of_batch(kv_models):
    """A sampled request's tokens depend on (seed, uid, position) only:
    served alone or in a batch, the same stream."""
    _, _, cfg, params = kv_models
    reqs = _requests(Request, cfg)
    mixed = _drive(Engine(cfg, params, batch_slots=4, max_len=64, seed=2,
                          device="cpu"), reqs)
    one = [r for r in _requests(Request, cfg) if r.uid == 3]
    solo = _drive(Engine(cfg, params, batch_slots=4, max_len=64, seed=2,
                         device="cpu"), one)
    assert solo[3] == mixed[3]


def test_cli_sampled_run_completes(capsys):
    """``--temperature 0.8`` (with top-k / top-p) on the CPU: every request
    finishes with its tokens; the engine takes the CLI's seed."""
    argv = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
            "--requests", "3", "--prompt-len", "6", "--max-new", "4",
            "--temperature", "0.8", "--top-k", "20", "--top-p", "0.9",
            "--seed", "4"]
    args = serve.parser().parse_args(argv)
    assert (args.temperature, args.top_k, args.top_p) == (0.8, 20, 0.9)
    cfg = registry.reduced("qwen3-4b")
    assert all(r.temperature == 0.8 and r.top_k == 20 and r.top_p == 0.9
               for r in serve.requests(args, cfg))
    assert serve.main(argv) == 0
    assert "requests=3 tokens=12" in capsys.readouterr().out
    eng = serve.engine(args, *serve.build(args))
    assert torch.equal(eng._base_key, seedgen.threefry_seed(4))

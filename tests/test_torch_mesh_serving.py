"""Mesh-sharded paged serving in the port (``Engine(mesh=...)``), on the
CPU, in process.

The reference gives no passing oracle for a sharded run here (its two
8-device subprocess tests fail under jax 0.9.0: ``shard_map``'s
``check_vma`` refuses its Pallas gather, and ``make_mesh``'s Explicit
axes refuse ``with_sharding_constraint``), so the port's sharded engines
are held to the reference's contract (``launch/steps.py``: a sharded
engine's greedy tokens equal the unsharded engine's) against two
oracles: the port's own unsharded engine and the reference's unsharded
engine, on the reference's params. The meshes are CPU positions
repeated (``launch.mesh.make_serving_meshes(..., device="cpu")``), the
counterpart of the reference tests' one device repeated: every sharded
code path runs, at the per-shard shapes. Reduced configs, 2 layers,
f32: tokens, counters and pool bytes are held exactly, step logits bit
for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.distributed import collectives
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve, steps
from repro_torch.models import frontends
from repro_torch.models import transformer as T
from repro_torch.serving import (Engine, PagedConfig, PrefixConfig, Request,
                                 Router, RouterConfig, SchedConfig,
                                 paged_cache)
from repro_torch.serving.mesh import shard

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

FAMS = {"kv": ("qwen3-4b", {}), "srf": ("qwen3-4b", {"attn_impl": "srf"}),
        "mla": ("deepseek-v2-lite-16b", {}), "ssd": ("mamba2-2.7b", {}),
        "hybrid": ("hymba-1.5b", {}),
        "encdec": ("seamless-m4t-large-v2", {})}

_models = {}
_ref_steps = {}


def _pair(arch, **over):
    """(jcfg, jparams, cfg, params): the reference's reduced 2-layer model
    and the port's, on the reference's params (cached)."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _models:
        jcfg = jregistry.reduced(arch, n_layers=2, **over)
        cfg = registry.reduced(arch, n_layers=2, **over)
        jparams = jT.init(jax.random.PRNGKey(0), jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu")
        _models[key] = (jcfg, jparams, cfg, params)
    return _models[key]


def _ref_engine(jcfg, jparams, **kw):
    """A reference engine; engines of one (config, page layout) share
    the first one's jitted step and encode step."""
    eng = jserving.Engine(jcfg, jparams, **kw)
    eng._step = _ref_steps.setdefault((eng.cfg, eng.paged), eng._step)
    eng._encode = _ref_steps.setdefault(eng.cfg, eng._encode)
    return eng


def _meshes(replicas, tp=2):
    return mesh_lib.make_serving_meshes(replicas, tp, device="cpu")


def _tokens(done):
    return {r.uid: list(r.out_tokens) for r in done}


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return _tokens(eng.run())


def _workload(cfg, n=16, seed=0):
    rng = np.random.default_rng(seed)
    spec = [(int(rng.integers(2, 20)), int(rng.integers(3, 8)))
            for _ in range(n)]
    prompts = [rng.integers(0, cfg.vocab, pl).astype(np.int32)
               for pl, _ in spec]
    encs = [frontends.synthetic_audio_features(rng, cfg)
            if cfg.is_encdec else None for _ in spec]
    return [(p, mn, e) for (_, mn), p, e in zip(spec, prompts, encs)]


def _reqs(work, make=Request):
    return [make(uid=i, prompt=p.copy(), max_new=mn, enc_emb=e)
            for i, (p, mn, e) in enumerate(work)]


@pytest.mark.parametrize("fam", list(FAMS))
def test_fam_matrix_through_sharded_router(fam):
    """The reference's FAM matrix: 16 mixed requests through a router of
    2 replicas x TP 2 give the unsharded port engine's tokens and the
    reference's unsharded engine's; both replicas serve; pool bytes per
    position are 1/TP of the pools for kv / srf, strictly between for
    the mixed hybrid and enc-dec plans, all of them where the layout
    degrades (MLA latents, SSD)."""
    arch, over = FAMS[fam]
    jcfg, jparams, cfg, params = _pair(arch, **over)
    work = _workload(cfg)
    single = Engine(cfg, params, batch_slots=8, max_len=64, device="cpu")
    want = _run(single, _reqs(work))
    ref = _run(_ref_engine(jcfg, jparams, batch_slots=8, max_len=64),
               _reqs(work, jserving.Request))
    assert want == ref, fam
    meshes = _meshes(2)
    router = Router([Engine(cfg, params, batch_slots=8, max_len=64,
                            mesh=m) for m in meshes])
    got = _run(router, _reqs(work))
    assert got == want, fam
    assert len(got) == 16
    assert all(e.stats["requests"] > 0 for e in router.engines), fam
    tp = shard.paged_tp(cfg, meshes[0])
    pbd = router.engines[0].cache_report()["pool_bytes_per_device"]
    pb = single.cache_report()["pool_bytes"]
    assert router.engines[0].cache_report()["pool_bytes"] == pb
    if fam in ("hybrid", "encdec"):
        assert tp == 2 and pb / tp < pbd < pb, (fam, pbd, pb)
    elif fam in ("kv", "srf"):
        assert tp == 2 and pbd * tp == pb, (fam, pbd, pb)
    else:
        assert tp == 1 and pbd == pb, (fam, pbd, pb)


@pytest.mark.parametrize("cell", ["kv", "int8", "srf", "hybrid", "encdec",
                                  "mla-srf"])
def test_sharded_step_logits_equal_unsharded(cell):
    """One prefill chunk and one decode step through
    ``make_paged_step(mesh=)`` and the plain step on the same pools give
    the same logits bit for bit (f32), and the sharded pools stitched
    back into global rows equal the plain pools (the int8 scales
    included: every shard stored the all-heads scale)."""
    arch, over = {"kv": ("qwen3-4b", {}), "int8": ("qwen3-4b", {}),
                  "srf": ("qwen3-4b", {"attn_impl": "srf"}),
                  "hybrid": ("hymba-1.5b", {}),
                  "encdec": ("seamless-m4t-large-v2", {}),
                  "mla-srf": ("deepseek-v2-lite-16b",
                              {"attn_impl": "srf"})}[cell]
    _, _, cfg, params = _pair(arch, **over)
    paged = PagedConfig(quantize_kv=cell == "int8")
    mesh = _meshes(1)[0]
    assert shard.paged_tp(cfg, mesh) == 2
    plain = paged_cache.init_pools(cfg, 6, 4, 3, device="cpu", paged=paged)
    pools = paged_cache.init_pools(cfg, 6, 4, 3, paged=paged, mesh=mesh)
    placed = shard.place_params(params, cfg, mesh)
    step = steps.make_paged_step(cfg, mesh=mesh, paged=paged,
                                 params_sds=params)
    plain_step = steps.make_paged_step(cfg)
    if cfg.is_encdec:
        rows = torch.randn(2, cfg.enc_len, cfg.d_model,
                           generator=torch.Generator().manual_seed(1))
        paged_cache.home(pools)["memory"][1:3] = rows
        plain["memory"][1:3] = rows
    gen = torch.Generator().manual_seed(0)
    tables = torch.tensor([[1, 2], [3, 4]])
    slots = torch.tensor([1, 2])
    toks = torch.randint(0, cfg.vocab, (2, 4), generator=gen)
    pos = torch.arange(4)[None].repeat(2, 1)
    qv = torch.tensor([[True] * 4, [True, True, True, False]])
    for t, p, v in ((toks, pos, qv),
                    (toks[:, :1], torch.tensor([[4], [3]]),
                     torch.tensor([[True], [True]]))):
        got, _ = step(placed, pools, t, p, v, tables, slots)
        want, _ = plain_step(params, plain, t, p, v, tables, slots)
        assert torch.equal(got, want), cell
    snap = paged_cache.pool_page_rows(pools, [1, 2, 3, 4], [1, 2])
    want = paged_cache.pool_page_rows(plain, [1, 2, 3, 4], [1, 2])
    for (path, a), (_, b) in zip(tree_lib.leaves_with_path(snap),
                                 tree_lib.leaves_with_path(want)):
        assert (a is None and b is None) or torch.equal(a, b), path
    if cell not in ("kv", "int8"):
        return
    with pytest.raises(ValueError, match="laid out"):     # other pages
        steps.make_paged_step(cfg, mesh=mesh, paged=PagedConfig(
            quantize_kv=cell != "int8"))(placed, pools, toks, pos, qv,
                                         tables, slots)


def test_tight_pool_preemption_with_sharded_pools():
    """A tight sharded pool preempts (snapshots of global rows, restored
    into every shard) and gives the tokens of a roomy unsharded run and
    of the reference's."""
    jcfg, jparams, cfg, params = _pair("qwen3-4b")
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, cfg.vocab, 3).astype(np.int32), 10, None)
            for _ in range(4)]
    geo = dict(max_batch=4, prefill_batch=2, prefill_chunk=4, page_size=4,
               table_width=4)
    tight = Engine(cfg, params, sched=SchedConfig(num_pages=9, **geo),
                   mesh=_meshes(1)[0])
    got = _run(tight, _reqs(work))
    roomy = _run(Engine(cfg, params, sched=SchedConfig(num_pages=33, **geo),
                        device="cpu"), _reqs(work))
    assert tight.stats["preemptions"] > 0
    assert got == roomy == _run(
        _ref_engine(jcfg, jparams,
                    sched=jserving.SchedConfig(num_pages=33, **geo)),
        _reqs(work, jserving.Request))


def test_int8_sharded_equals_int8_unsharded():
    """Int8 pages under TP 2: the values shard on the head dim, the
    scales (max over every shard's heads) replicate; greedy tokens equal
    the unsharded int8 engine's and the reference's int8 engine's."""
    jcfg, jparams, cfg, params = _pair("qwen3-4b")
    work = _workload(cfg, n=6, seed=3)
    pc = PagedConfig(quantize_kv=True)
    one = Engine(cfg, params, batch_slots=4, max_len=32, paged=pc,
                 device="cpu")
    want = _run(one, _reqs(work))
    sh = Engine(cfg, params, batch_slots=4, max_len=32, paged=pc,
                mesh=_meshes(1)[0])
    assert _run(sh, _reqs(work)) == want
    assert want == _run(_ref_engine(jcfg, jparams, batch_slots=4,
                                    max_len=32,
                                    paged=jserving.PagedConfig(True)),
                        _reqs(work, jserving.Request))
    assert sh.cache_report()["pool_bytes_per_device"] < \
        one.cache_report()["pool_bytes"]


def _preempt_then_migrate(e0_mesh, e1_mesh):
    """Replica 0's tight pool preempts; replica 1 (one geometry, more
    pages) adopts the snapshot-carrying sequences through migration."""
    _, _, cfg, params = _pair("qwen3-4b")
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, cfg.vocab, 3).astype(np.int32), 10, None)
            for _ in range(4)]
    geo = dict(max_batch=4, prefill_batch=2, prefill_chunk=4, page_size=4,
               table_width=4)

    def mk(n, mesh):
        return Engine(cfg, params, sched=SchedConfig(num_pages=n, **geo),
                      device="cpu", mesh=mesh)
    want = _run(mk(33, None), _reqs(work))
    e0, e1 = mk(9, e0_mesh), mk(33, e1_mesh)
    router = Router([e0, e1], RouterConfig(migrate=True))
    reqs = _reqs(work)
    for r in reqs:
        e0.submit(r)
        router.home[r.uid] = 0
    router.run()
    restored = [ev["uid"] for ev in e1.metrics.events
                if ev["event"] == "restored"]
    return want, _tokens(reqs), e0, e1, router, restored


@pytest.mark.parametrize("widths", [(2, 2), (2, 1), (1, 2)])
def test_preempted_sequence_migrates_across_tp_widths(widths):
    """A preemption snapshot holds global rows and the router's pool
    signature compares global shapes, so a preempted sequence moves
    between sharded replicas and between a TP 2 and a TP 1 replica."""
    ms = [None if w == 1 else m for w, m in zip(widths, _meshes(2))]
    want, got, e0, e1, router, restored = _preempt_then_migrate(*ms)
    assert e0.stats["preemptions"] > 0 and router.stats["migrations"] > 0
    assert restored, "no snapshot-carrying sequence was adopted"
    assert got == want
    assert router._pool_signature(e0) == router._pool_signature(e1)


def test_fresh_requests_migrate_between_sharded_replicas():
    """The reference's migration cell: a single-slot sharded replica's
    backlog drains through a roomy sharded one, tokens unchanged."""
    _, _, cfg, params = _pair("qwen3-4b")
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, cfg.vocab, 3).astype(np.int32), 10, None)
            for _ in range(4)]
    want = _run(Engine(cfg, params, batch_slots=4, max_len=16,
                       device="cpu"), _reqs(work))
    meshes = _meshes(2)
    slot1 = SchedConfig(max_batch=1, prefill_batch=1, prefill_chunk=4,
                        page_size=4, num_pages=5, table_width=4)
    e0 = Engine(cfg, params, sched=slot1, mesh=meshes[0])
    e1 = Engine(cfg, params, batch_slots=4, max_len=16, mesh=meshes[1])
    router = Router([e0, e1])
    for r in _reqs(work):
        e0.submit(r)
        router.home[r.uid] = 0
    assert _tokens(router.run()) == want
    assert router.stats["migrations"] > 0 and e1.stats["requests"] > 0


@pytest.mark.parametrize("seeded", [False, True])
def test_srf_sharded_greedy_and_sampled(seeded):
    """SRF and seeded SRF (mixed embed seeds), greedy and sampled rows
    in one batch: the sharded engine's tokens equal the unsharded
    engine's; the quality probe reads head 0 from its shard and
    publishes the unsharded engine's statistics."""
    import dataclasses
    _, _, cfg, params = _pair("qwen3-4b", attn_impl="srf")
    if seeded:
        cfg = dataclasses.replace(cfg, srf=dataclasses.replace(
            cfg.srf, seeded=True))
        params = T.init(cfg, seed=0, device="cpu")
    work = _workload(cfg, n=8, seed=5)

    def reqs():
        return [Request(uid=i, prompt=p.copy(), max_new=mn,
                        temperature=0.8 if i % 2 else 0.0, top_k=20,
                        embed_seed=(i % 3) * 7 if seeded else 0)
                for i, (p, mn, _) in enumerate(work)]
    one = Engine(cfg, params, batch_slots=4, max_len=32, device="cpu",
                 quality_every=4)
    sh = Engine(cfg, params, batch_slots=4, max_len=32, mesh=_meshes(1)[0],
                quality_every=4)
    assert _run(sh, reqs()) == _run(one, reqs())
    q = [e.metrics.snapshot()["gauges"]["srf_quality"] for e in (one, sh)]
    assert list(q[0].values()) == list(q[1].values()) and q[0]


def test_prefix_cache_at_tp2():
    """The prefix cache over sharded pools (COW forks and tail copies on
    every shard): tokens and prefix counters equal the unsharded
    engine's."""
    _, _, cfg, params = _pair("qwen3-4b")
    rng = np.random.default_rng(7)
    common = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    prompts = [np.concatenate([common, rng.integers(
        0, cfg.vocab, int(n)).astype(np.int32)]) for n in (3, 5, 0, 8, 2, 6)]

    def drive(mesh):
        eng = Engine(cfg, params, batch_slots=2, max_len=48, device="cpu",
                     prefix=PrefixConfig(), mesh=mesh)
        out = {}
        for wave in (prompts[:2], prompts[2:]):
            out.update(_run(eng, [Request(uid=len(out) + i, prompt=p.copy(),
                                          max_new=5)
                                  for i, p in enumerate(wave)]))
        v = eng.metrics.value_sum
        return out, [int(v(k)) for k in (
            "prefix_hits_total", "prefix_hit_tokens_total",
            "prefix_cow_forks_total")]
    got, want = drive(_meshes(1)[0]), drive(None)
    assert got == want and want[1][0] > 0


def test_mesh_raises_where_the_reference_raises():
    """A pure-SSM stack has no sharded step (``tp_axis`` raises
    ``ValueError``, its engine degrades to the plain step); too few
    devices for the meshes raise ``ValueError``."""
    _, _, cfg, params = _pair("mamba2-2.7b")
    axis = collectives.Axis("model", (torch.device("cpu"),) * 2)
    with pytest.raises(ValueError, match="pure ssm"):
        T.paged_step([params, params], cfg, [{}, {}],
                     torch.zeros(1, 1, dtype=torch.long),
                     torch.zeros(1, 1, dtype=torch.long),
                     torch.ones(1, 1, dtype=torch.bool),
                     torch.zeros(1, 1, dtype=torch.long),
                     torch.zeros(1, dtype=torch.long), tp_axis=axis)
    eng = Engine(cfg, params, batch_slots=2, max_len=32, mesh=_meshes(1)[0])
    assert not isinstance(eng.pools, collectives.ShardedTree)
    with pytest.raises(ValueError, match="need 4 devices"):
        mesh_lib.make_serving_meshes(2, 2, devices=["cpu"] * 3)


def test_serve_cli_sharded_replicas_on_cpu(capsys):
    """``--device cpu --replicas 2 --model-parallel 2``: the router over
    two sharded replicas serves the tokens of the unsharded CLI run."""
    base = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
            "--requests", "4", "--max-new", "4", "--prompt-len", "8"]
    assert serve.main(base + ["--replicas", "2", "--model-parallel",
                              "2"]) == 0
    out = capsys.readouterr().out
    assert "engine=router" in out
    assert "'pool_bytes_per_device': " in out
    args = serve.parser().parse_args(base)
    cfg, params = serve.build(args)
    want = _tokens(serve.serve(args, cfg, params)["done"])
    args_r = serve.parser().parse_args(base + ["--replicas", "2",
                                               "--model-parallel", "2"])
    eng = serve.router(args_r, cfg, params,
                       meshes=mesh_lib.make_serving_meshes(2, 2,
                                                           device="cpu"))
    assert _tokens(serve.serve(args_r, eng=eng)["done"]) == want

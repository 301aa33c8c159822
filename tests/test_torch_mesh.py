"""The port's mesh layout rules, elastic resharding and compressed
cross-pod gradient mean against the reference's, on the CPU.

Layout rules (``launch/mesh``, ``distributed/sharding``,
``serving/mesh/shard``, ``ft/elastic``) are pure functions of shapes and
mesh axes: the port's must equal the reference's exactly, spec for spec
(``tuple(spec)``), on the same shapes. The reference's meshes are built
from its one CPU device repeated (its own tests' ``_fake_mesh``), the
port's from one CPU position repeated (``launch.mesh.make_mesh(...,
device="cpu")``).
``compressed_pod_mean`` runs against the reference's on a one-device
(pod, data, model) mesh within 1e-4 of the largest value (the two
packages' FFTs and generator normals differ in the last bits, as in
``test_torch_train.test_compression_helpers_match_reference``).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jregistry
from repro.distributed import collectives as jcollectives
from repro.distributed import sharding as jS
from repro.ft import elastic as jelastic
from repro.models import transformer as jT
from repro.optim import compression as JC
from repro.serving import PagedConfig as JPagedConfig
from repro.serving.mesh import shard as jshard
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as S
from repro_torch.distributed.sharding import P
from repro_torch.ft import elastic
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim import compression as C
from repro_torch.serving import PagedConfig
from repro_torch.serving.mesh import shard

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

VARIANTS = [(arch, over) for arch in registry.ARCHS
            for over in ({}, {"attn_impl": "srf"})]


def _jmesh(shape, axes):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)


def _mesh(shape, axes):
    return mesh_lib.make_mesh(shape, axes, device="cpu")


def _meshes(shape, axes=("data", "model")):
    return _mesh(shape, axes), _jmesh(shape, axes)


def _jflat(specs):
    """{path: tuple(spec)} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jS._path_str(p): tuple(s) for p, s in flat}


def _flat(specs):
    """{path: tuple(spec)} of a port spec tree (None entries dropped, as
    jax drops them)."""
    return {p: tuple(s) for p, s in tree_lib.leaves_with_path(specs)
            if s is not None}


def _meta(jtree):
    """The reference's shape tree as meta tensors, one structure."""
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), jtree)


_sds = {}


def _shapes(arch, over, full=False):
    key = (arch, tuple(sorted(over.items())), full)
    if key not in _sds:
        jcfg = (jregistry.get if full else jregistry.reduced)(arch, **over)
        _sds[key] = (jcfg, jax.eval_shape(
            lambda: jT.init(jax.random.PRNGKey(0), jcfg)))
    return _sds[key]


def _cfg(arch, over, full=False):
    return (registry.get if full else registry.reduced)(arch, **over)


# ---------------------------------------------------------------------------
# launch/mesh
# ---------------------------------------------------------------------------

def test_meshes_and_their_errors():
    meshes = mesh_lib.make_serving_meshes(2, 3, device="cpu")
    assert [mesh_lib.describe(m) for m in meshes] == ["data=1 x model=3"] * 2
    assert all(m.devices.shape == (1, 3) for m in meshes)
    assert meshes[0].axis_devices("model") == [torch.device("cpu")] * 3
    assert meshes[0].axis_devices("pod") == [torch.device("cpu")]
    cards = [torch.device("cuda", i) for i in range(2)]
    with pytest.raises(ValueError, match="need 4 devices"):
        mesh_lib.make_serving_meshes(2, 2, devices=cards)
    m = mesh_lib.make_serving_meshes(1, 2, devices=cards)[0]
    assert list(m.devices.flat) == cards and m.home == cards[0]
    with pytest.raises(ValueError):
        mesh_lib.make_production_mesh(devices=cards)
    with pytest.raises(ValueError):
        mesh_lib.make_production_mesh(multi_pod=True, devices=cards * 200)
    pm = mesh_lib.make_production_mesh(devices=[torch.device("cpu")] * 256)
    assert mesh_lib.describe(pm) == "data=16 x model=16"
    m3 = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"),
                            device="cpu")
    assert S.axis_size(m3, "pod") == 2 and S.dp_axes(m3) == ("pod", "data")
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="need 4 devices"):
            mesh_lib.make_serving_meshes(2, 2)


# ---------------------------------------------------------------------------
# serving/mesh/shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_paged_tp_matches_reference_for_every_config(tp):
    mesh, jmesh = _meshes((1, tp))
    got = {}
    for arch, over in VARIANTS:
        for full in (False, True):
            t = shard.paged_tp(_cfg(arch, over, full), mesh)
            jcfg = (jregistry.get if full else jregistry.reduced)(arch,
                                                                   **over)
            assert t == jshard.paged_tp(jcfg, jmesh), (arch, over, full)
            got[(arch, over.get("attn_impl"), full)] = t
    assert shard.paged_tp(_cfg("qwen3-4b", {}), None) == 1
    if tp == 2:
        # hymba: 25 q / 5 kv heads degrade at full width, the reduced
        # config (4 / 2) shards; MLA latents and SSD always replicate
        assert got[("hymba-1.5b", None, True)] == 1
        assert got[("hymba-1.5b", None, False)] == 2
        assert got[("qwen2-vl-2b", None, True)] == 2
        assert got[("deepseek-v2-lite-16b", None, True)] == 1
        assert got[("mamba2-2.7b", None, False)] == 1
    else:
        assert got[("qwen2-vl-2b", None, True)] == 1     # 2 kv heads % 4


@pytest.mark.parametrize("int8", [False, True])
def test_pool_specs_match_reference(int8):
    """Every config's pool specs, the mixed hybrid and enc-dec plans
    included (kv shards, ssd and memory replicate; int8 scales
    replicate)."""
    mesh, jmesh = _meshes((1, 2))
    paged = PagedConfig(quantize_kv=True) if int8 else None
    jpaged = JPagedConfig(quantize_kv=True) if int8 else None
    for arch, over in VARIANTS:
        got = _flat(shard.pool_specs(_cfg(arch, over), mesh, paged))
        want = _jflat(jshard.pool_specs(jregistry.reduced(arch, **over),
                                        jmesh, jpaged))
        assert got == want, (arch, over)
    hy = _flat(shard.pool_specs(_cfg("hymba-1.5b", {}), mesh, paged))
    assert hy["paged/0/attn/k"] == (None, None, None, "model", None)
    assert all(e is None for k, s in hy.items() if "ssm" in k for e in s)
    ed = _flat(shard.pool_specs(_cfg("seamless-m4t-large-v2", {}), mesh,
                                paged))
    assert ed["memory"] == ()
    if int8:
        assert ed["paged/0/attn/k_scale"] == (None,) * 4


def test_serving_param_specs_match_reference():
    """Column-parallel q/k/v (cross attention and MLA up-projections
    included), q/k/v biases and the SRF P-model stacks sharded; wo, the
    MLP, embeddings, norms and the encoder replicated; on the port's own
    param trees (reduced) and on the full-width shapes."""
    mesh, jmesh = _meshes((1, 2))
    for arch, over in VARIANTS:
        jcfg, sds = _shapes(arch, over)
        want = _jflat(jshard.serving_param_specs(sds, jcfg, jmesh))
        cfg = _cfg(arch, over)
        own = T.init(cfg, seed=0, device="cpu")
        assert _flat(shard.serving_param_specs(own, cfg, mesh)) == want, \
            (arch, over)
        assert _flat(shard.serving_param_specs(_meta(sds), cfg, mesh)) == \
            want
    for arch in ("qwen2.5-14b", "seamless-m4t-large-v2", "qwen2-vl-2b"):
        jcfg, sds = _shapes(arch, {}, full=True)
        assert _flat(shard.serving_param_specs(
            _meta(sds), _cfg(arch, {}, True), mesh)) == \
            _jflat(jshard.serving_param_specs(sds, jcfg, jmesh)), arch
    spec = _flat(shard.serving_param_specs(
        T.init(_cfg("qwen3-4b", {}), seed=0, device="cpu"),
        _cfg("qwen3-4b", {}), mesh))
    assert spec["segments/0/attn/wq"] == (None, None, "model")
    assert spec["segments/0/attn/wo"] == (None, None, None)


@pytest.mark.parametrize("axes,shape", [(("data", "model"), (1, 1)),
                                        (("data", "model"), (2, 4)),
                                        (("pod", "data", "model"), (2, 2, 2))])
def test_param_specs_cover_every_leaf_and_match_reference(axes, shape):
    mesh, jmesh = _meshes(shape, axes)
    for arch in registry.ARCHS:
        jcfg, sds = _shapes(arch, {})
        want = _jflat(jS.param_specs(sds, jmesh))
        assert len(want) == len(jax.tree.leaves(sds))
        own = T.init(_cfg(arch, {}), seed=0, device="cpu")
        got = _flat(S.param_specs(own, mesh))
        assert got == want, arch
        assert len(got) == len(tree_lib.leaves(own))
    jcfg, sds = _shapes("qwen3-4b", {}, full=True)
    assert _flat(S.param_specs(_meta(sds), mesh)) == \
        _jflat(jS.param_specs(sds, jmesh))


def test_fits_zero1_and_opt_state_specs_match_reference():
    for shape in ((1, 16), (4, 2), (2, 4)):
        mesh, jmesh = _meshes(shape)
        for dims, dim, names in (((1536,), 0, "model"), ((25,), 0, "model"),
                                 ((10, 3), 1, "model"), ((8, 6), 0, "data"),
                                 ((12,), 0, ("data", "model")),
                                 ((3,), 5, "model")):
            assert S._fits(dims, dim, mesh, names) == \
                jS._fits(dims, dim, jmesh, names), (shape, dims, names)
        jcfg, sds = _shapes("qwen3-4b", {})
        jps = jS.param_specs(sds, jmesh)
        params = _meta(sds)
        ps = S.param_specs(params, mesh)
        assert _flat(S.zero1_specs(params, ps, mesh)) == \
            _jflat(jS.zero1_specs(sds, jps, jmesh))
        got = S.opt_state_specs(None, params, ps, mesh)
        want = jS.opt_state_specs(None, sds, jps, jmesh)
        assert _flat(got) == _jflat(want)
    mesh, jmesh = _meshes((4, 2))
    z = S.zero1_specs({"w": torch.empty(64, 32)}, {"w": P(None, "model")},
                      mesh)
    assert tuple(z["w"]) == ("data", "model") == tuple(jS.zero1_specs(
        {"w": jax.ShapeDtypeStruct((64, 32), jnp.float32)},
        {"w": JP(None, "model")}, jmesh)["w"])


@pytest.mark.parametrize("shape,axes", [((1, 1), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model")),
                                        ((4, 2), ("data", "model"))])
def test_batch_and_cache_specs_match_reference(shape, axes):
    mesh, jmesh = _meshes(shape, axes)
    for b in (8, 3):
        batch = {"tokens": jax.ShapeDtypeStruct((b, 64), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((b, 64), jnp.int32),
                 "pos3": jax.ShapeDtypeStruct((3, b, 64), jnp.int32),
                 "enc_emb": jax.ShapeDtypeStruct((b, 16, 80), jnp.float32)}
        assert _flat(S.batch_specs_tree(_meta(batch), mesh)) == \
            _jflat(jS.batch_specs_tree(batch, jmesh))
    for arch, over in VARIANTS:
        jcfg = jregistry.reduced(arch, **over)
        csds = jax.eval_shape(lambda: jT.init_serve_cache(jcfg, 4, 32))
        got = _flat(S.cache_specs_tree(_meta(csds), _cfg(arch, over), mesh))
        assert got == _jflat(jS.cache_specs_tree(csds, jcfg, jmesh)), \
            (arch, over)
    # the port's own serve cache: host-int "idx" / "pos" specs are ()
    own = T.init_serve_cache(_cfg("qwen3-4b", {}), 4, 32, device="meta")
    specs = _flat(S.cache_specs_tree(own, _cfg("qwen3-4b", {}), mesh))
    assert specs["pos"] == () and specs["segments/0/idx"] == ()


# ---------------------------------------------------------------------------
# ft/elastic
# ---------------------------------------------------------------------------

def test_elastic_degrade_remesh_and_shrink_plan_match_reference():
    mesh2 = SimpleNamespace(axis_names=("data", "model"),
                            devices=np.zeros((2, 2)))
    mesh42, jmesh42 = _meshes((4, 2))
    for spec, shape, m, jm in (
            (("data",), (4, 8), mesh2, mesh2),
            (("data",), (3, 8), mesh2, mesh2),
            ((("data", "model"),), (8,), mesh2, mesh2),
            ((("data", "model"),), (6,), mesh2, mesh2),
            (("data", "model"), (12, 10), mesh42, jmesh42),
            (("data", "model"), (13, 10), mesh42, jmesh42),
            (("data", "model"), (12, 9), mesh42, jmesh42)):
        assert tuple(elastic._degrade(P(*spec), shape, m)) == \
            tuple(jelastic._degrade(JP(*spec), shape, jm)), (spec, shape)
    for n, model in ((8, 2), (6, 3), (4, 1)):
        assert elastic.viable_data_axis(n, model) == \
            jelastic.viable_data_axis(n, model)
        m = elastic.remesh(["cpu"] * n, model)
        assert m.devices.shape == jelastic.remesh(
            jax.devices() * n, model).devices.shape
        assert m.axis_names == ("data", "model")
    with pytest.raises(ValueError):
        elastic.viable_data_axis(6, 4)
    for old, failed, model in ((8, (2, 5), 2), (4, (1, 3), 1), (3, (), 1)):
        assert elastic.shrink_plan(old, failed, model) == \
            jelastic.shrink_plan(old, failed, model)


def test_reshard_tree_round_trips():
    """``reshard_tree`` places one contiguous block a position (shard
    order over the named axes, row-major over a tuple of names), degrades
    what does not divide, and ``gather`` gives back the tree; the
    reference's round trip on its (1, 1) mesh agrees."""
    tree = {"w": np.arange(48, dtype=np.float32).reshape(8, 6),
            "b": np.arange(6, dtype=np.float32),
            "odd": np.arange(15, dtype=np.float32).reshape(5, 3)}
    specs = {"w": P("data", "model"), "b": P(("data", "model")),
             "odd": P("data", "model")}
    mesh = _mesh((4, 2), ("data", "model"))
    out = elastic.reshard_tree(tree, specs, mesh)
    for k, v in tree.items():
        np.testing.assert_array_equal(out[k].gather().numpy(), v)
    assert tuple(out["odd"].spec) == (None, None)         # 5 % 4, 3 % 2
    assert tuple(out["b"].spec) == (None,)                # 6 % 8
    blk = out["w"].blocks[(1, 1)]
    assert blk.is_contiguous() and blk.shape == (2, 3)
    np.testing.assert_array_equal(blk.numpy(), tree["w"][2:4, 3:6])
    one = elastic.reshard_tree(tree, specs, elastic.remesh(["cpu"], 1))
    jone = jelastic.reshard_tree(
        tree, {"w": JP("data", "model"), "b": JP(("data", "model")),
               "odd": JP("data", "model")},
        jelastic.remesh(jax.devices()[:1], 1))
    for k in tree:
        np.testing.assert_array_equal(one[k].gather().numpy(),
                                      np.asarray(jone[k]))


# ---------------------------------------------------------------------------
# distributed/collectives
# ---------------------------------------------------------------------------

def test_collectives_over_per_shard_values():
    axis = collectives.Axis("model", (torch.device("cpu"),) * 3)
    parts = [torch.full((2, 1, 3), float(i)) for i in range(3)]
    st = collectives.stitch_heads(parts, axis, head_dim=1)
    assert st.shape == (2, 3, 3) and torch.equal(st[:, 2], parts[2][:, 0])
    a = torch.tensor([1.0, 5.0, -2.0])
    b = torch.tensor([3.0, -1.0, -7.0])
    assert torch.equal(collectives.pmax([a, b, a], axis),
                       torch.tensor([3.0, 5.0, -2.0]))
    assert torch.equal(collectives.pmean([a, b, a], axis), (a + b + a) / 3)
    x = torch.ones(2)
    assert all(t is x for t in collectives.broadcast(x, axis))
    run = collectives.axis_shard_map(lambda u, v: u + v, axis)
    assert [float(t) for t in run([1.0, 2.0, 3.0], [10.0] * 3)] == \
        [11.0, 12.0, 13.0]
    with pytest.raises(ValueError):
        run([1.0], [2.0])


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((40, 30)).astype(np.float32),
            "b": rng.standard_normal(10).astype(np.float32),
            "c": rng.standard_normal(300).astype(np.float32)}


def test_compressed_pod_mean_matches_reference_on_one_device_mesh():
    """One pod, one device, three steps carrying the error state, against
    the reference's ``compressed_pod_mean`` (its ``shard_map`` over a
    (1, 1, 1) mesh): within 1e-4 of each leaf's largest value. The
    residual identity ``err' + mean == g + err`` holds in both within
    f32 rounding (2e-6 of the largest), and the uncompressed mean of one
    pod is the gradient itself."""
    jmesh = _jmesh((1, 1, 1), ("pod", "data", "model"))
    mesh = _mesh((1, 1, 1), ("pod", "data", "model"))
    cc = C.CompressionConfig(chunk=256, ratio=4, seed=3, min_size=64)
    jc = JC.CompressionConfig(chunk=256, ratio=4, seed=3, min_size=64)
    g_np = _grads(0)
    tg = tree_lib.map(torch.from_numpy, g_np)
    jg = jax.tree.map(jnp.asarray, g_np)
    err, jerr = C.init_error(tg), JC.init_error(jg)
    jmean_fn = jax.jit(
        lambda g, e, step: jcollectives.compressed_pod_mean(g, e, jmesh, jc,
                                                            step))
    for step in range(3):
        mean, new_err = collectives.compressed_pod_mean(tg, err, mesh, cc,
                                                        step)
        jmean, jnew = jmean_fn(jg, jerr, step)
        for k in g_np:
            for a, b in ((mean[k], jmean[k]), (new_err[k], jnew[k])):
                w = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                           atol=1e-4 * np.abs(w).max())
            lhs = (new_err[k] + mean[k]).numpy()
            rhs = (tg[k] + err[k]).numpy()
            np.testing.assert_allclose(lhs, rhs, rtol=0,
                                       atol=2e-6 * np.abs(rhs).max())
        err, jerr = new_err, jnew
    assert mean["b"].dtype == torch.float32
    plain = collectives.pod_mean_plain(tg, mesh)
    jplain = jcollectives.pod_mean_plain(jg, jmesh)
    for k in g_np:
        assert torch.equal(plain[k], tg[k])
        np.testing.assert_array_equal(plain[k].numpy(),
                                      np.asarray(jplain[k]))


def test_compressed_pod_mean_of_two_pods_is_the_mean_of_their_sketches():
    """Two pods with their own gradients and error states: the mean is
    the unsketch of the two sketches' mean (in pod order), each pod's
    new error is its own residual, and replicated gradients give the
    one-pod result exactly."""
    mesh = _mesh((2, 1, 1), ("pod", "data", "model"))
    cc = C.CompressionConfig(chunk=256, ratio=4, seed=3, min_size=64)
    gs = [tree_lib.map(torch.from_numpy, _grads(s)) for s in (1, 2)]
    es = [tree_lib.map(lambda x: 0.1 * x, _grads(s + 10)) for s in (1, 2)]
    es = [tree_lib.map(torch.from_numpy, e) for e in es]
    mean, new_errs = collectives.compressed_pod_mean(gs, es, mesh, cc, 4)
    trips = [C.roundtrip_with_feedback(g, e, cc, 4) for g, e in zip(gs, es)]
    sk_mean = tree_lib.map(lambda a, b: (a + b) / 2, trips[0][0],
                           trips[1][0])
    want = C.decompress_tree(sk_mean, gs[0], cc, 4)
    for k in gs[0]:
        assert torch.equal(mean[k], want[k])
        for i in range(2):
            assert torch.equal(new_errs[i][k], trips[i][2][k])
    plain = collectives.pod_mean_plain(gs, mesh)
    assert torch.equal(plain["a"], (gs[0]["a"] + gs[1]["a"]) / 2)
    one = collectives.compressed_pod_mean(
        gs[0], es[0], _mesh((1, 1, 1), ("pod", "data", "model")), cc, 4)
    two = collectives.compressed_pod_mean(gs[0], es[0], mesh, cc, 4)
    for k in gs[0]:
        assert torch.equal(one[0][k], two[0][k])
        assert torch.equal(one[1][k], two[1][k])


def test_trainer_with_mesh_matches_reference(tmp_path):
    """``Trainer(mesh=...)`` with ``compress_dp`` (grad step, compressed
    pod mean, AdamW, the error state carried) against the reference's
    trainer on its one-device (pod, data, model) mesh: 4 steps of reduced
    qwen3-4b from the same params, losses within 1e-4 relative; two pods
    (replicated gradients) give the one-pod losses exactly."""
    from repro.train import trainer as jtrainer
    from repro.launch import steps as jsteps
    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    jcfg = jregistry.reduced("qwen3-4b", n_layers=2)
    hyper = dict(lr=1e-2, warmup=2, total_steps=4)
    cc = dict(chunk=256, ratio=4, seed=3, min_size=64)
    common = dict(num_steps=4, batch=2, seq=16, log_every=1, ckpt_every=100)
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(
        **common, ckpt_dir=str(tmp_path / "j"), compress_dp=True,
        hyper=jsteps.TrainHyper(**hyper),
        compression=JC.CompressionConfig(**cc)),
        mesh=_jmesh((1, 1, 1), ("pod", "data", "model")))
    want = [r["loss"] for r in jt.train()["log"]]
    losses = []
    for pods in (1, 2):
        tr = Trainer(cfg, TrainerConfig(
            **common, ckpt_dir=str(tmp_path / f"p{pods}"), device="cpu",
            compress_dp=True, hyper=steps.TrainHyper(**hyper),
            compression=C.CompressionConfig(**cc)),
            mesh=_mesh((pods, 1, 1), ("pod", "data", "model")))
        start = jT.init(jax.random.PRNGKey(0), jcfg)
        tr.params = T.requires_grad(convert.params_from_jax(
            jax.tree.map(np.asarray, start), cfg, device="cpu"))
        tr.opt_state = adamw.init(tr.params)
        tr.err = C.init_error(tr.params)
        losses.append([r["loss"] for r in tr.train()["log"]])
    np.testing.assert_allclose(losses[0], want, rtol=1e-4)
    assert losses[0] == losses[1]

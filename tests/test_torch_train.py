"""The port's training path against ``repro``'s on the CPU.

Reduced qwen3-4b (2 layers, f32), the reference's params carried over
with ``convert.params_from_jax``, batches from the synthetic stream
(numpy, bit-identical in both packages). Held to the reference:
``cross_entropy`` with masked labels (rtol 1e-6 f32), ``loss_fn`` for
full and SRF attention (rtol 1e-5), every gradient leaf, the SRF
projection's ``g`` / ``d0`` / ``d1`` among them (rtol 1e-4, atol 1e-5 x
max|grad| of the leaf), ``adamw.update`` and ``warmup_cosine`` (rtol
1e-6), three ``make_train_step`` steps (losses and params, rtol 1e-4),
the compression helpers, and bf16 SRF with the reference's Pallas
kernels in interpret mode. Then the port's own trainer, checkpoint
manager, loader and straggler watchdog, as the reference's tests
(``test_trainer_ft.py``, ``test_checkpoint.py``, ``test_optim.py``)
hold the reference's, and a checkpoint written by the reference's
manager restored into the port's trainer.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import registry as jregistry
from repro.data import synth as jsynth
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro.optim import compression as JC
from repro.optim import schedule as jschedule
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import synth
from repro_torch.data.loader import ShardedLoader, device_batch
from repro_torch.ft.straggler import StragglerConfig, StragglerWatchdog
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, schedule
from repro_torch.optim import compression as C
from repro_torch.train.trainer import CrashInjected, Trainer, TrainerConfig

GRAD_RTOL = 1e-4
GRAD_ATOL_SHARE = 1e-5


# the other dense configs, held at one remat setting
DENSE_CONFIGS = ["qwen2.5-14b", "mistral-nemo-12b", "internlm2-20b"]


def _with_qkv_bias(jcfg, jparams):
    """Nonzero q/k/v biases for a ``qkv_bias`` config (the reference
    inits them to zeros, which would leave the bias path untested)."""
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        attn = jparams["segments"][0]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(
                rng.standard_normal(attn[name].shape) * 0.1, attn[name].dtype)
    return jparams


_jinits = {}


def _jinit(jcfg):
    """The reference's params of ``jcfg`` from key 0, made once a config
    (jax arrays are immutable, so tests share them)."""
    if jcfg not in _jinits:
        _jinits[jcfg] = jT.init(jax.random.PRNGKey(0), jcfg)
    return _jinits[jcfg]


def _models(attn, arch="qwen3-4b", **over):
    jcfg = jregistry.reduced(arch, attn_impl=attn, **over)
    cfg = registry.reduced(arch, attn_impl=attn, **over)
    jparams = _with_qkv_bias(jcfg, jax.tree.map(lambda a: a, _jinit(jcfg)))
    params = T.requires_grad(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return jcfg, jparams, cfg, params


def _batch(cfg, step=0, b=2, seq=32):
    host = synth.full_batch(cfg, b, seq, step, seed=1)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            device_batch(host, "cpu"))


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flat_port(tree):
    return {k: v.detach().float().numpy()
            for k, v in tree_lib.leaves_with_path(tree) if v is not None}


@pytest.fixture(scope="module", params=["full", "srf"])
def models(request):
    return _models(request.param)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_masks_and_matches(dtype):
    """Value and logits gradient, labels out of range masked (rtol 1e-6
    in f32; bf16 logits: rtol 1e-5 on the value, the gradient within a
    bf16 spacing)."""
    rng = np.random.default_rng(0)
    v, vocab = 300, 250                   # columns past vocab: padding
    logits = (rng.standard_normal((3, 7, v)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 7))
    labels[0, :3] = -1
    labels[1, 2] = vocab
    labels[2, 6] = v + 5
    jl = jnp.asarray(logits, dtype)
    jloss, jgrad = jax.value_and_grad(
        lambda x: jlayers.cross_entropy(x, jnp.asarray(labels), vocab))(jl)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    loss = layers.cross_entropy(tl, torch.from_numpy(labels), vocab)
    loss.backward()
    rtol = 1e-6 if dtype == "float32" else 1e-5
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rtol)
    assert tl.grad.dtype == tl.dtype
    g, jg = tl.grad.float().numpy(), np.asarray(jgrad, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-9)
    else:
        np.testing.assert_allclose(g, jg, rtol=2 ** -7, atol=1e-6)
    assert not g[0, :3].any() and not g[1, 2].any() and not g[2, 6].any()


def test_cross_entropy_chunks_rows(monkeypatch):
    """More rows than one chunk: the same value and gradient."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((5, 9, 64)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(-2, 70, (5, 9)))
    out = []
    for rows in (layers.XENT_ROWS, 4):
        monkeypatch.setattr(layers, "XENT_ROWS", rows)
        x = logits.clone().requires_grad_()
        loss = layers.cross_entropy(x, labels, 60)
        loss.backward()
        out.append((loss.detach(), x.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_unembed_is_f32():
    w = torch.randn(8, 5).bfloat16()
    x = torch.randn(2, 3, 8).bfloat16()
    y = layers.unembed(w, x)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jlayers.unembed(
            jnp.asarray(w.float().numpy(), jnp.bfloat16),
            jnp.asarray(x.float().numpy(), jnp.bfloat16))), rtol=1e-6)


_ref_grads = {}


def _ref_loss_and_grads(jcfg, jparams, jb):
    """The reference's loss and gradients on the batch ``jb``: one jitted
    ``value_and_grad``, its result shared by the tests that ask for the
    same config, params and batch (the remat settings differ in the port
    only)."""
    key = (jcfg, id(jparams), tuple((k, np.asarray(v).tobytes())
                                    for k, v in sorted(jb.items())))
    if key not in _ref_grads:
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jT.loss_fn(p, jcfg, b), has_aux=True))(jparams, jb)
        _ref_grads[key] = (float(jl), jg, jparams)
    return _ref_grads[key][:2]


def _loss_and_grads(jcfg, jparams, cfg, params, jb, tb):
    jl, jg = _ref_loss_and_grads(jcfg, jparams, jb)
    loss, metrics = T.loss_fn(params, cfg, tb)
    leaves = [p for p in tree_lib.leaves(params) if p.requires_grad]
    got = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    grads = tree_lib.map(lambda p: got.get(id(p)), params)
    return (jl, jg), (loss.item(), grads, metrics)


GRAD_CASES = [pytest.param("qwen3-4b", r, id=r)
              for r in ("none", "full", "dots")] + \
    [pytest.param(a, "full", id=a) for a in DENSE_CONFIGS]


@pytest.mark.parametrize("arch,remat", GRAD_CASES)
def test_loss_and_every_grad_match_reference(models, arch, remat):
    """loss_fn (rtol 1e-5) and every gradient leaf; for SRF that includes
    the projection's g, d0 and d1 of every layer and kv head. qwen3-4b
    under every remat setting, the other dense configs under one
    (qwen2.5-14b with nonzero q/k/v biases)."""
    if arch == "qwen3-4b":
        jcfg, jparams, cfg, params = models
    else:
        jcfg, jparams, cfg, params = _models(models[2].attn_impl, arch)
        assert not cfg.qkv_bias or float(jnp.abs(
            jparams["segments"][0]["attn"]["bq"]).min()) > 0
    cfg = dataclasses.replace(cfg, remat=remat)
    jb, tb = _batch(cfg)
    (jl, jg), (loss, grads, metrics) = _loss_and_grads(
        jcfg, jparams, cfg, params, jb, tb)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    want, got = _flat_jax(jg), _flat_port(grads)
    assert set(want) == set(got)
    if cfg.attn_impl == "srf":
        assert {"segments/0/attn/srf/0/g", "segments/0/attn/srf/0/d0",
                "segments/0/attn/srf/0/d1"} <= set(got)
    for k in want:
        np.testing.assert_allclose(
            got[k], want[k], rtol=GRAD_RTOL,
            atol=GRAD_ATOL_SHARE * np.abs(want[k]).max(), err_msg=k)


def test_scan_group_two_equals_one():
    """scan_group=2 (nested recompute) gives scan_group=1's loss and
    gradients, and both match the reference (4 layers, remat full)."""
    jcfg = jregistry.reduced("qwen3-4b", n_layers=4, remat="full")
    jparams = _jinit(jcfg)
    out = []
    for g in (1, 2):
        cfg = registry.reduced("qwen3-4b", n_layers=4, remat="full",
                               scan_group=g)
        params = T.requires_grad(convert.params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
        jb, tb = _batch(cfg)
        loss, _ = T.loss_fn(params, cfg, tb)
        out.append((loss.item(), torch.autograd.grad(
            loss, tree_lib.leaves(params))))
    jl = jax.jit(lambda p, b: jT.loss_fn(p, jcfg, b)[0])(jparams, jb)
    assert abs(out[0][0] - out[1][0]) < 1e-5
    np.testing.assert_allclose(out[1][0], float(jl), rtol=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("q_chunk", [1024, 16])
def test_softmax_attn_matches_reference(q_chunk):
    """Causal GQA softmax attention, unchunked and in query chunks (each
    recomputed in the backward), against the reference's, with its
    gradients (rtol 1e-5)."""
    from repro.models import attention as jA
    from repro_torch.models import attention as A
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, 64, 8), (2, 2, 64, 8), (2, 2, 64, 8)))
    dy = rng.standard_normal((2, 4, 64, 8)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jA._softmax_attn(*a, 0.3, causal=True,
                                        q_chunk=q_chunk) * dy)
    jout = jA._softmax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            0.3, causal=True, q_chunk=q_chunk)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = A._softmax_attn(*t, 0.3, causal=True, q_chunk=q_chunk)
    g = torch.autograd.grad(out, t, torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_unported_modes_and_kinds_raise():
    from repro_torch.models import attention as A
    cfg = registry.reduced("qwen3-4b")
    params = T.init(cfg, seed=0, device="cpu")
    lp = tree_lib.unbind(params["segments"][0], cfg.n_layers)[0]
    x = torch.zeros(1, 4, cfg.d_model)
    pos = torch.arange(4)[None]
    with pytest.raises(NotImplementedError):
        A.attention(lp["attn"], cfg, x, pos, "encoder")
    for mode in ("prefill", "decode"):          # ported: they need a cache
        with pytest.raises(ValueError, match="needs a cache"):
            A.attention(lp["attn"], cfg, x, pos, mode)
    with pytest.raises(NotImplementedError):
        T.layer_apply(lp, cfg, "dense_cross", x, pos)
    with pytest.raises(NotImplementedError):
        T.run_segment(params["segments"][0], cfg, "dense", x, pos, "encoder")


def test_forward_counts_every_spinner_call_once_per_pass():
    """With remat full the SRF feature maps run again in the backward:
    the plain spinner (CPU) is called 2 per layer in the forward and 2
    per layer in the recompute."""
    from repro_torch.kernels import ref
    cfg = registry.reduced("qwen3-4b", attn_impl="srf", remat="full")
    params = T.requires_grad(T.init(cfg, seed=0, device="cpu"))
    _, tb = _batch(cfg)
    calls = []
    orig = ref.spinner_project_ref

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    ref.spinner_project_ref = counted
    try:
        loss, _ = T.loss_fn(params, cfg, tb)
        n_fwd = len(calls)
        torch.autograd.grad(loss, tree_lib.leaves(params))
    finally:
        ref.spinner_project_ref = orig
    assert n_fwd == 2 * cfg.n_layers
    assert len(calls) == 4 * cfg.n_layers


def test_bf16_srf_loss_matches_reference_kernels(monkeypatch):
    """bf16 SRF (the full-width dtype) with the reference's spinner in
    interpret mode, i.e. the TPU kernel's numerics: loss within 1e-2
    relative, gradients finite with the reference's global norm within
    5%."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "interpret")
    jcfg, jparams, cfg, params = _models("srf", dtype="bfloat16")
    assert params["head"].dtype == torch.bfloat16
    jb, tb = _batch(cfg, b=2, seq=16)
    (jl, jg), (loss, grads, _) = _loss_and_grads(jcfg, jparams, cfg, params,
                                                 jb, tb)
    np.testing.assert_allclose(loss, jl, rtol=1e-2)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all()
               for g in tree_lib.leaves(grads))
    np.testing.assert_allclose(float(adamw.global_norm(grads)),
                               float(jadamw.global_norm(jg)), rtol=5e-2)


def _opt_tree():
    rng = np.random.default_rng(3)
    return {"layer": {"mlp": {"wi": rng.standard_normal((4, 6))},
                      "ln1": {"w": rng.standard_normal(6)},
                      "attn": {"bq": rng.standard_normal(3),
                               "wq": rng.standard_normal((6, 3))}},
            "head": rng.standard_normal((6, 5))}


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_update_matches_reference(clip):
    """Two updates from the same state: params, moments, count and the
    gradient norm (rtol 1e-6; clipping on and off, decay masked)."""
    cfg = adamw.AdamWConfig(clip_norm=clip)
    jcfg = jadamw.AdamWConfig(clip_norm=clip)
    p_np = _opt_tree()
    g_np = jax.tree.map(lambda a: a * 0.3 + 0.1, _opt_tree())
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p_np)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), g_np)
    tp = tree_lib.map(lambda a: torch.tensor(a, dtype=torch.float32), p_np)
    tg = tree_lib.map(lambda a: torch.tensor(a, dtype=torch.float32), g_np)
    js, ts = jadamw.init(jp), adamw.init(tp)
    for lr in (0.1, 0.05):
        jp, js, jstats = jadamw.update(jg, js, jp, lr, jcfg)
        tp, ts, stats = adamw.update(tg, ts, tp, lr, cfg)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
    for a, b in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        want, got = _flat_jax(b), _flat_port(a)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=k)
    assert int(ts["count"]) == int(js["count"]) == 2
    assert ts["count"].dtype == torch.int32
    assert adamw.decay_mask(tp) == jadamw.decay_mask(jp)


def test_adamw_bf16_params_keep_dtype_and_f32_moments():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    s = adamw.init(p)
    assert s["mu"]["w"].dtype == torch.float32
    p, s, _ = adamw.update({"w": torch.full((4,), 0.5,
                                            dtype=torch.bfloat16)},
                           s, p, 0.01)
    assert p["w"].dtype == torch.bfloat16 and (p["w"] < 1).all()


def test_adamw_none_grad_leaves_param_alone():
    p = {"seed": torch.tensor([3, 4]), "w": torch.ones(2)}
    s = adamw.init(p)
    p, s, _ = adamw.update({"seed": None, "w": torch.ones(2)}, s, p, 0.1)
    assert p["seed"].tolist() == [3, 4] and (p["w"] < 1).all()


def test_warmup_cosine_matches_reference():
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        for warm, total in ((10, 100), (0, 1), (5, 5)):
            np.testing.assert_allclose(
                float(schedule.warmup_cosine(step, 3e-4, warm, total)),
                float(jschedule.warmup_cosine(step, 3e-4, warm, total)),
                rtol=1e-6)


def _jax_train_step(jcfg, jhyper):
    """The reference's train step on a path-keyed flat param dict: its
    ``make_train_step`` for trees without tuples, and the same loss,
    schedule and ``adamw.update`` for SRF trees, whose tuple of
    per-block dicts the reference's ``adamw.update`` takes for its own
    (param, mu, nu) triples (IndexError)."""
    def step(flat, state, i, batch):
        treedef = jax.tree.structure(jparams_proto)

        def loss(f):
            p = jax.tree.unflatten(treedef, [f[k] for k in keys])
            return jT.loss_fn(p, jcfg, batch, jhyper.aux_weight)
        (l, metrics), g = jax.value_and_grad(loss, has_aux=True)(flat)
        lr = jschedule.warmup_cosine(i, jhyper.lr, jhyper.warmup,
                                     jhyper.total_steps)
        flat, state, stats = jadamw.update(g, state, flat, lr, jhyper.adam)
        return flat, state, {"loss": l, "lr": lr, **metrics, **stats}
    jparams_proto = _jinit(jcfg)
    keys = list(_flat_jax(jparams_proto))
    return jax.jit(step)


_jsteps = {}
JHYPER = jsteps.TrainHyper(lr=1e-2, warmup=2, total_steps=10)


def _jstep(jcfg):
    """The reference's own jitted ``make_train_step`` at ``JHYPER``, one
    a config (its compiled shapes shared by the tests that run it)."""
    if jcfg not in _jsteps:
        _jsteps[jcfg] = jax.jit(jsteps.make_train_step(jcfg, JHYPER))
    return _jsteps[jcfg]


@pytest.mark.parametrize("attn", ["full", "srf"])
def test_three_train_steps_match_reference(attn):
    """Three make_train_step steps from the same params and AdamW state:
    every metric and the params (rtol 1e-4, atol 1e-6). Full attention
    also against the reference's own ``make_train_step``."""
    jcfg, jparams, cfg, params = _models(attn)
    hyper = steps.TrainHyper(lr=1e-2, warmup=2, total_steps=10)
    jhyper = JHYPER
    flat = {k: v for k, v in zip(_flat_jax(jparams),
                                 jax.tree.leaves(jparams))}
    jstate = jadamw.init(flat)
    state = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jadamw.init(jparams)), params, device="cpu")
    jfn = _jax_train_step(jcfg, jhyper)
    fn = steps.make_train_step(cfg, hyper)
    own = None
    if attn == "full":
        own = (jparams, jadamw.init(jparams), _jstep(jcfg))
    for i in range(3):
        jb, tb = _batch(cfg, step=i)
        flat, jstate, jm = jfn(flat, jstate, jnp.asarray(i), jb)
        params, state, m = fn(params, state, i, tb)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        if own is not None:
            p_own, s_own, f_own = own
            p_own, s_own, m_own = f_own(p_own, s_own, jnp.asarray(i), jb)
            own = (p_own, s_own, f_own)
            np.testing.assert_allclose(float(m["loss"]),
                                       float(m_own["loss"]), rtol=1e-4)
    got = _flat_port(params)
    for k, v in flat.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    if own is not None:
        want = _flat_jax(own[0])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert int(state["count"]) == 3


def test_opt_state_from_jax_checks_shapes():
    jcfg, jparams, cfg, params = _models("full")
    st = jax.tree.map(np.asarray, jadamw.init(jparams))
    out = convert.opt_state_from_jax(st, params, device="cpu")
    assert out["count"].dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in tree_lib.leaves(out["mu"]))
    st["mu"]["head"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        convert.opt_state_from_jax(st, params, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-4b", "seamless-m4t-large-v2",
                                  "qwen2-vl-2b"])
def test_synth_batches_identical(arch):
    cfg = registry.reduced(arch)
    jcfg = jregistry.reduced(arch)
    for step, shard in ((0, 0), (7, 3)):
        a = synth.full_batch(cfg, 3, 24, step, seed=5, shard=shard)
        b = jsynth.full_batch(jcfg, 3, 24, step, seed=5, shard=shard)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_compression_helpers_match_reference():
    """Sketch, unsketch, the error-feedback round trip and wire bytes on
    the same gradients (whitened circulant generators drawn from the
    same threefry key: rtol 1e-4 of the largest value)."""
    rng = np.random.default_rng(0)
    g_np = {"a": rng.standard_normal((40, 30)).astype(np.float32),
            "b": rng.standard_normal(10).astype(np.float32)}
    for scaling in ("contractive", "unbiased"):
        cc = C.CompressionConfig(chunk=256, ratio=4, seed=3, min_size=64,
                                 scaling=scaling)
        jc = JC.CompressionConfig(chunk=256, ratio=4, seed=3, min_size=64,
                                  scaling=scaling)
        x = torch.from_numpy(g_np["a"])
        y = C.compress_leaf(x, cc, 2, step=5)
        jy = JC.compress_leaf(jnp.asarray(g_np["a"]), jc, 2, step=5)
        scale = np.abs(np.asarray(jy)).max()
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-4 * scale)
        xh = C.decompress_leaf(y, cc, 2, x.shape, x.dtype, step=5)
        jxh = JC.decompress_leaf(jy, jc, 2, x.shape, jnp.float32, step=5)
        np.testing.assert_allclose(xh.numpy(), np.asarray(jxh), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(jxh)).max())
    cc = C.CompressionConfig(chunk=256, ratio=4, seed=3, min_size=64)
    jc = JC.CompressionConfig(chunk=256, ratio=4, seed=3, min_size=64)
    tg = tree_lib.map(torch.from_numpy, g_np)
    jg = jax.tree.map(jnp.asarray, g_np)
    err, jerr = C.init_error(tg), JC.init_error(jg)
    for step in range(3):
        sk, recon, err = C.roundtrip_with_feedback(tg, err, cc, step=step)
        jsk, jrecon, jerr = JC.roundtrip_with_feedback(jg, jerr, jc,
                                                       step=step)
        for a, b in ((sk, jsk), (recon, jrecon), (err, jerr)):
            for k in g_np:
                w = np.asarray(b[k])
                np.testing.assert_allclose(a[k].numpy(), w, rtol=0,
                                           atol=1e-4 * np.abs(w).max())
    assert sk["b"] is tg["b"] or torch.equal(sk["b"], tg["b"])
    assert C.wire_bytes(tg, cc) == JC.wire_bytes(jg, jc)


def test_compression_error_feedback_identity_and_stability():
    """The EF algebra (applied + err == the sum of true gradients) and
    the bounded error memory of the contractive scaling, as the
    reference's ``test_optim`` holds them."""
    g = {"w": torch.randn(512, generator=torch.Generator().manual_seed(0))}
    err = C.init_error(g)
    applied = torch.zeros(512)
    cc = C.CompressionConfig(chunk=512, ratio=8, seed=0, min_size=1)
    for step in range(20):
        _, recon, err = C.roundtrip_with_feedback(g, err, cc, step=step)
        applied = applied + recon["w"]
    total = 20 * g["w"]
    assert float(torch.linalg.norm(applied + err["w"] - total)) < \
        1e-3 * float(torch.linalg.norm(total))
    assert float(torch.linalg.norm(err["w"])) < 12 * float(
        torch.linalg.norm(g["w"]))


# --- trainer, checkpoints, loader, watchdog --------------------------------

def _tcfg(tmp_path, **kw):
    base = dict(num_steps=30, batch=4, seq=32, ckpt_every=10, log_every=5,
                ckpt_dir=str(tmp_path), device="cpu",
                hyper=steps.TrainHyper(lr=1e-2, warmup=5, total_steps=30))
    base.update(kw)
    return TrainerConfig(**base)


def test_trainer_loss_decreases(tmp_path):
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    out = Trainer(cfg, _tcfg(tmp_path, num_steps=40)).train()
    losses = [r["loss"] for r in out["log"]]
    assert losses[-1] < losses[0] - 0.3, losses


@pytest.mark.parametrize("attn", ["full", "srf"])
def test_crash_resume_is_bit_exact(tmp_path, attn):
    """Run A uninterrupted; run B crashes at step 17, restarts, resumes
    from the step-10 checkpoint: the final params are equal."""
    cfg = registry.reduced("qwen3-4b", n_layers=2, attn_impl=attn)
    ta = Trainer(cfg, _tcfg(tmp_path / "a"))
    out_a = ta.train()
    tb = Trainer(cfg, _tcfg(tmp_path / "b"), crash_at=17)
    with pytest.raises(CrashInjected):
        tb.train()
    tb.ckpt.wait()
    tb2 = Trainer(cfg, _tcfg(tmp_path / "b"))
    assert tb2.try_resume()
    assert tb2.step == 10
    out_b = tb2.train()
    for a, b in zip(tree_lib.leaves(ta.params), tree_lib.leaves(tb2.params)):
        assert torch.equal(a, b)
    assert all(p.requires_grad for p in tree_lib.leaves(tb2.params))
    assert out_a["final_step"] == out_b["final_step"] == 30


def test_trainer_mesh_raises_and_compress_dp_without_mesh_runs(tmp_path):
    cfg = registry.reduced("qwen3-4b", n_layers=2)
    with pytest.raises(NotImplementedError):
        Trainer(cfg, _tcfg(tmp_path / "m"), mesh=object())
    out = Trainer(cfg, _tcfg(tmp_path, num_steps=6,
                             compress_dp=True)).train()
    assert out["final_step"] == 6


@pytest.mark.parametrize("attn", ["full", "srf"])
def test_trainer_restores_reference_checkpoint(tmp_path, attn):
    """The reference's CheckpointManager writes reference state (params
    and AdamW state after a step: the reference's own train step for
    full attention; for SRF, whose tuple of per-block dicts the
    reference's optimizer cannot take, moments from the reference's
    gradients); the port's trainer resumes from it with exactly those
    values, and trains on."""
    jcfg = jregistry.reduced("qwen3-4b", attn_impl=attn)
    cfg = registry.reduced("qwen3-4b", attn_impl=attn)
    jparams = _jinit(jcfg)
    jb, _ = _batch(cfg)
    if attn == "full":
        jparams, jstate, _ = _jstep(jcfg)(
            jparams, jadamw.init(jparams), jnp.asarray(0), jb)
    else:
        jg = _ref_loss_and_grads(jcfg, jparams, jb)[1]
        jstate = {"mu": jg, "nu": jax.tree.map(jnp.square, jg),
                  "count": jnp.ones((), jnp.int32)}
    JCheckpointManager(str(tmp_path), async_save=False).save(
        1, {"params": jparams, "opt": jstate})
    tr = Trainer(cfg, _tcfg(tmp_path, num_steps=2))
    assert tr.try_resume() and tr.step == 1
    want = _flat_jax({"params": jparams, "opt": jstate})
    got = _flat_port({"params": tr.params, "opt": tr.opt_state})
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tr.train()["final_step"] == 2


def _ckpt_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 8), generator=g),
                       "b16": torch.arange(6, dtype=torch.bfloat16)},
            "opt": {"mu": torch.ones(3),
                    "count": torch.zeros((), dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_reference_layout(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = _ckpt_tree()
    mgr.save(7, tree, metadata={"loss": 1.5})
    restored, step, meta = mgr.restore(_ckpt_tree(seed=1))
    assert step == 7 and meta["loss"] == 1.5
    for a, b in zip(tree_lib.leaves(tree), tree_lib.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference's manager reads the port's files
    jtree = {"params": {"w": jnp.zeros((4, 8)),
                        "b16": jnp.zeros(6, jnp.bfloat16)},
             "opt": {"mu": jnp.zeros(3), "count": jnp.zeros((), jnp.int32)}}
    jr, jstep, _ = JCheckpointManager(str(tmp_path)).restore(jtree)
    assert jstep == 7 and jr["params"]["b16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jr["params"]["w"]),
                                  tree["params"]["w"].numpy())
    np.testing.assert_array_equal(
        np.asarray(jr["params"]["b16"], np.float32),
        tree["params"]["b16"].float().numpy())


def test_checkpoint_latest_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _ckpt_tree())
    assert mgr.available_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_uncommitted_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _ckpt_tree())
    os.makedirs(tmp_path / "step_00000009")
    assert mgr.latest_step() == 1


def test_checkpoint_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _ckpt_tree())
    path = tmp_path / "step_00000001" / "arrays.npz"
    data = bytearray(path.read_bytes())
    data[-20] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(Exception):
        mgr.restore(_ckpt_tree())


def test_checkpoint_async_save_waits_and_snapshots(tmp_path):
    """The save snapshots to host memory at once: an in-place update after
    save() does not reach the file."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = _ckpt_tree()
    want = tree["params"]["w"].clone()
    mgr.save(5, tree)
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore(_ckpt_tree())[0]["params"]["w"], want)


def test_checkpoint_shape_mismatch_and_legacy_alias(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"attn": {"srf": {"g": torch.ones(3)}}})
    out, _, _ = mgr.restore({"attn": {"srf": ({"g": torch.zeros(3)},)}})
    assert torch.equal(out["attn"]["srf"][0]["g"], torch.ones(3))
    with pytest.raises(ValueError):
        mgr.restore({"attn": {"srf": {"g": torch.zeros(4)}}})


def test_data_stream_determinism():
    b1 = synth.lm_batch(100, 4, 16, step=3, seed=7, shard=2)
    b2 = synth.lm_batch(100, 4, 16, step=3, seed=7, shard=2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(
        b1["tokens"], synth.lm_batch(100, 4, 16, step=4, seed=7,
                                     shard=2)["tokens"])


def test_loader_reset_replays():
    ld = ShardedLoader(lambda step, shard: {"x": np.full((2,), step)},
                       prefetch=2)
    it = iter(ld)
    assert [next(it)[0], next(it)[0]] == [0, 1]
    ld.reset(1)
    s, b = next(iter(ld))
    assert s == 1 and b["x"][0] == 1
    ld.stop()
    t = device_batch({"tokens": np.arange(4, dtype=np.int32)}, "cpu")
    assert t["tokens"].dtype == torch.int32


def test_straggler_watchdog_reassigns():
    wd = StragglerWatchdog(4, StragglerConfig(grace_steps=2, threshold=1.5))
    ev = None
    for step in range(10):
        for h in range(4):
            ev = wd.record(h, step, 1.0 if h != 2 else 3.0) or ev
    assert ev is not None and ev["host"] == 2
    assert ev["action"] == "reassign" and len(wd.events) >= 1


def test_straggler_exclude_policy():
    wd = StragglerWatchdog(4, StragglerConfig(grace_steps=1, threshold=1.5,
                                              policy="exclude"))
    for step in range(6):
        for h in range(4):
            wd.record(h, step, 5.0 if h == 0 else 1.0)
    shard_map = wd.active_shard_map()
    assert 0 not in shard_map and len(shard_map) == 3


def test_straggler_reassign_with_all_peers_excluded_warns():
    wd = StragglerWatchdog(4, StragglerConfig(grace_steps=1, threshold=1.5))
    for step in range(4):
        for h in range(4):
            wd.record(h, step, 1.0)
    for h in (0, 1, 3):
        wd.hosts[h].excluded = True
    assert wd.record(2, 5, 9.0) is None
    ev = wd._act(2, 5, 1.0)
    assert ev["action"] == "warn" and "reassigned_to_host" not in ev
    assert wd.hosts[2].shard == 2


def test_train_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "m.json"
    assert train_cli.main(["--arch", "qwen3-4b", "--reduced", "--device",
                           "cpu", "--steps", "2", "--attn", "srf",
                           "--ckpt-dir", str(tmp_path / "ck"),
                           "--metrics-out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "attn=srf" in text and "resumed=False" in text
    assert '"step": 2' in text and out.exists()
    # a second run resumes from the final checkpoint and has nothing left
    assert train_cli.main(["--arch", "qwen3-4b", "--reduced", "--device",
                           "cpu", "--steps", "2", "--ckpt-dir",
                           str(tmp_path / "ck")]) == 0
    assert "resumed=True start_step=2" in capsys.readouterr().out


def test_train_cli_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])


@pytest.mark.parametrize("argv", [["--compress-dp"], ["--seeded-srf"],
                                  ["--attn", "full", "--seeded-srf"]])
def test_train_cli_refuses_what_it_cannot_run(argv, tmp_path):
    """``--compress-dp`` needs a mesh (not ported); ``--seeded-srf`` needs
    SRF attention. Both are usage errors, not silently ignored."""
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                        "--steps", "1", "--ckpt-dir", str(tmp_path), *argv])
    assert not any(tmp_path.iterdir())


def test_train_cli_seeded_srf_on_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu", "--steps",
            "1", "--attn", "srf", "--seeded-srf", "--ckpt-dir",
            str(tmp_path / "ck")]
    tr = train_cli.trainer(train_cli.parser().parse_args(argv))
    assert tr.cfg.attn_impl == "srf" and tr.cfg.srf.seeded
    assert train_cli.main(argv) == 0
    text = capsys.readouterr().out
    assert "attn=srf seeded_srf=True" in text and '"step": 1' in text

"""Training of the SSD, hybrid, MoE and MLA families in the port against
``repro``'s on the CPU.

Reduced configs (2-3 layers, f32, ``ssm_chunk`` 16; the MoE configs at
``moe_capacity_factor`` 8.0, as the reference's parity tests), the
reference's params carried over with ``convert.params_from_jax``,
batches from the synthetic stream (numpy, bit-identical in both
packages). Held to the reference:

* ``loss_fn`` (rtol 1e-5), its ``xent`` and ``aux``, and every gradient
  leaf (rtol 1e-4, atol 1e-5 x the leaf's largest |grad|) against
  ``jax.value_and_grad(loss_fn)``: mamba2-2.7b under every remat
  setting at seq 64 (4 chunks) and seq 40 (a padded last chunk),
  hymba-1.5b with full and SRF attention, moonshot-v1-16b-a3b full and
  SRF (the MoE aux loss at weight 0.01), deepseek-v2-lite-16b MLA and
  MLA + SRF;
* two ``make_train_step`` steps of mamba2 and moonshot against the
  reference's jitted ``make_train_step`` (every metric and the params);
* the SSD chunk body's checkpoint: under autograd ``ssm_apply(mode=
  "train")`` saves no (B, c, c, nh) gate and no (B, c, c) scores (the
  reference's ``jax.checkpoint(step)``), and under ``torch.no_grad``
  it enters no checkpoint and gives the same bits;
* ``profile_train.step_rates``' N: the active params;
* the training CLI on each family's reduced config.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import registry
from repro_torch.data import synth
from repro_torch.data.loader import device_batch
from repro_torch.launch import profile_train, steps
from repro_torch.launch import train as train_cli
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL_SHARE = 1e-5
STEP_RTOL = 1e-4

MOE = {"moe_capacity_factor": 8.0}

_jinits = {}


def _models(arch, attn="full", **over):
    """Both packages' reduced configs and params (the reference's from
    key 0, made once a config; the port's converted from them)."""
    if arch in ("moonshot-v1-16b-a3b", "deepseek-v2-lite-16b"):
        over = {**MOE, **over}
    jcfg = jregistry.reduced(arch, attn_impl=attn, **over)
    cfg = registry.reduced(arch, attn_impl=attn, **over)
    if jcfg not in _jinits:
        _jinits[jcfg] = jT.init(jax.random.PRNGKey(0), jcfg)
    jparams = _jinits[jcfg]
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


# (arch, attention, remat, seq)
GRAD_CASES = [
    pytest.param("mamba2-2.7b", "full", "none", 64, id="mamba2-none-64"),
    pytest.param("mamba2-2.7b", "full", "full", 64, id="mamba2-full-64"),
    pytest.param("mamba2-2.7b", "full", "dots", 64, id="mamba2-dots-64"),
    pytest.param("mamba2-2.7b", "full", "none", 40, id="mamba2-none-40"),
    pytest.param("mamba2-2.7b", "full", "full", 40, id="mamba2-full-40"),
    pytest.param("hymba-1.5b", "full", "none", 40, id="hymba-full"),
    pytest.param("hymba-1.5b", "srf", "full", 40, id="hymba-srf"),
    pytest.param("moonshot-v1-16b-a3b", "full", "full", 32,
                 id="moonshot-full"),
    pytest.param("moonshot-v1-16b-a3b", "srf", "none", 32,
                 id="moonshot-srf"),
    pytest.param("deepseek-v2-lite-16b", "full", "none", 32,
                 id="deepseek-mla"),
    pytest.param("deepseek-v2-lite-16b", "srf", "full", 32,
                 id="deepseek-mla-srf"),
]


@pytest.mark.parametrize("arch,attn,remat,seq", GRAD_CASES)
def test_loss_and_every_grad_match_reference(arch, attn, remat, seq):
    """loss_fn (rtol 1e-5), xent and aux, and every gradient leaf (rtol
    1e-4, atol 1e-5 x the leaf's largest) against the reference's
    ``jax.value_and_grad(loss_fn)``: the SSD block's leaves (a_log,
    dt_bias, the conv, the projections), the hybrid fusion norms, the
    experts and router, MLA's latent projections and SRF's g, d0, d1."""
    jcfg, jparams, cfg, params = _models(arch, attn)
    cfg = dataclasses.replace(cfg, remat=remat)
    jb, tb = _batch(cfg, seq=seq)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jT.loss_fn(p, jcfg, b), has_aux=True))(jparams, jb)
    loss, metrics = T.loss_fn(params, cfg, tb)
    leaves = [p for p in tree_lib.leaves(params) if p.requires_grad]
    got = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    grads = tree_lib.map(lambda p: got.get(id(p)), params)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert (float(metrics["aux"].detach()) > 0) == cfg.is_moe
    want, have = _flat_jax(jg), _flat_port(grads)
    assert set(want) == set(have)
    if cfg.family in ("ssm", "hybrid"):
        assert "segments/0/ssm/a_log" in have
    if attn == "srf":
        assert "segments/0/attn/srf/0/g" in have
    for k in want:
        np.testing.assert_allclose(
            have[k], want[k], rtol=GRAD_RTOL,
            atol=GRAD_ATOL_SHARE * np.abs(want[k]).max(), err_msg=k)


JHYPER = jsteps.TrainHyper(lr=1e-3, warmup=1, total_steps=4)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "moonshot-v1-16b-a3b"])
def test_two_train_steps_match_reference(arch):
    """Two ``make_train_step`` steps from the same params and AdamW state
    against the reference's jitted ``make_train_step``: every metric
    (loss, xent, aux, lr, grad norm) and every param after the second
    step (rtol 1e-4, atol 1e-6), at the enc-dec test's learning rate."""
    jcfg, jparams, cfg, params = _models(arch, remat="full")
    jstep = jax.jit(jsteps.make_train_step(jcfg, JHYPER))
    fn = steps.make_train_step(cfg, steps.TrainHyper(
        lr=JHYPER.lr, warmup=JHYPER.warmup, total_steps=JHYPER.total_steps))
    state, jp, jstate = adamw.init(params), jparams, jadamw.init(jparams)
    for i in range(2):
        jb, tb = _batch(cfg, step=i, seq=48)
        params, state, m = fn(params, state, i, tb)
        jp, jstate, jm = jstep(jp, jstate, jnp.asarray(i), jb)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=STEP_RTOL, atol=1e-7, err_msg=k)
    want, have = _flat_jax(jp), _flat_port(params)
    assert set(want) == set(have)
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=STEP_RTOL,
                                   atol=1e-6, err_msg=k)
    assert int(state["count"]) == 2


def _ssm_case(seq=64):
    # ssm_state 8: no other tensor of the block has the scores' shape
    cfg = registry.reduced("mamba2-2.7b", ssm_state=8)
    gen = torch.Generator().manual_seed(0)
    p = ssm.ssm_init(gen, cfg, torch.float32)
    x = torch.randn((2, seq, cfg.d_model), generator=gen)
    return cfg, p, x


def test_chunk_body_is_checkpointed_under_autograd(monkeypatch):
    """ssm_apply(mode="train") at 4 chunks: with grad, every chunk's body
    runs under a checkpoint and the forward saves no (B, c, c, nh) gate
    and no (B, c, c) scores; the backward runs. Under ``torch.no_grad``
    no checkpoint is entered and the output has the same bits."""
    cfg, p, x = _ssm_case()
    b, c, nh = x.shape[0], cfg.ssm_chunk, cfg.ssm_heads
    assert x.shape[1] == 4 * c
    calls = []
    orig = ssm.ckpt.checkpoint

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(ssm.ckpt, "checkpoint", counted)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = ssm.ssm_apply(leaves, cfg, x, "train")
    assert len(calls) == 4
    assert shapes, "the forward saved nothing outside the chunks"
    assert not [s for s in shapes if s[:3] == (b, c, c)]
    grads = torch.autograd.grad(y.square().sum(), list(leaves.values()))
    assert all(torch.isfinite(g).all() for g in grads)
    calls.clear()
    with torch.no_grad():
        y0 = ssm.ssm_apply(p, cfg, x, "train")
    assert not calls
    assert torch.equal(y0, y.detach())


def test_unchecked_chunks_would_save_the_gate():
    """The shapes the checkpoint test looks for are the ones the plain
    chunk body saves: run without the checkpoint, the forward keeps the
    (B, c, c, nh) gate and the (B, c, c) scores (as a (B, c, c, 1)
    view)."""
    cfg, p, x = _ssm_case()
    b, c, nh = x.shape[0], cfg.ssm_chunk, cfg.ssm_heads
    shapes = []
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        state = torch.zeros((b, nh, cfg.ssm_state, cfg.ssm_head_dim))
        tri = torch.ones((c, c), dtype=torch.bool).tril()
        xs = torch.randn((b, c, nh, cfg.ssm_head_dim), requires_grad=True)
        bs, cs = (torch.randn((b, c, cfg.ssm_state)) for _ in range(2))
        dt = torch.rand((b, c, nh))
        a = ssm._decay_rate(leaves)
        ssm._chunk_body(state, xs, bs, cs, dt * a, dt, tri)
    assert (b, c, c, nh) in shapes and (b, c, c, 1) in shapes


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_chunk_checkpoint_keeps_gradients(arch):
    """The checkpointed scan's gradients equal the plain loop's (the
    chunk body run without a checkpoint) to the last rounding step."""
    cfg = registry.reduced(arch)
    gen = torch.Generator().manual_seed(1)
    p = ssm.ssm_init(gen, cfg, torch.float32)
    x = torch.randn((2, 40, cfg.d_model), generator=gen)
    out = []
    for remat in (True, False):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        if remat:
            y = ssm.ssm_apply(leaves, cfg, x, "train")
        else:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(ssm.ckpt, "checkpoint",
                           lambda fn, *a, **k: fn(*a))
                y = ssm.ssm_apply(leaves, cfg, x, "train")
        out.append(torch.autograd.grad(y.square().sum(),
                                       list(leaves.values())))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["qwen3-4b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b", "mamba2-2.7b"])
def test_step_rates_count_active_params(arch):
    """The bf16-peak share is 6 N tokens / step / peak with N the active
    params: ``param_count()`` for a dense or SSD config, the routed top-k
    and shared experts' for MoE (moonshot at 8 layers: about a third)."""
    cfg = registry.get(arch, n_layers=8)
    r = profile_train.step_rates(cfg, 2, 4096, 0.5)
    n = cfg.active_param_count()
    assert r["tokens_s"] == 2 * 4096 / 0.5 and r["step_ms"] == 500.0
    assert math.isclose(r["bf16_peak_share"], 6 * n * 8192 / 0.5
                        / profile_train.PEAK_BF16_FLOP_PER_S, rel_tol=1e-12)
    if cfg.is_moe:
        assert n < cfg.param_count() / 3
    else:
        assert n == cfg.param_count()


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b",
                                  "moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b"])
def test_cli_trains_reduced_family_on_cpu(tmp_path, capsys, arch):
    """``python -m repro_torch.launch.train --arch <family> --reduced
    --device cpu --steps 2``: the run's line and step 2's finite loss."""
    assert train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "32",
                           "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and '"step": 2' in out
    losses = [float(line.split('"loss": ')[1].split(",")[0])
              for line in out.splitlines() if '"loss": ' in line]
    assert losses and all(math.isfinite(v) for v in losses)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-large-v2",
                                  "moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b", "mamba2-2.7b"])
def test_spinner_calls_follow_the_layer_plan(arch):
    """With SRF and remat full, one training step maps features 2 times a
    self-attention layer in the forward and 2 in the recompute: the
    decoder's layers that own attention state (``_layer_plan``) and the
    enc-dec encoder's; an SSD stack none (the counts ``chip_smoke.py``
    asserts on the card, with the plain spinner counted here)."""
    from repro_torch.kernels import ref
    cfg = registry.reduced(arch, attn_impl="srf", remat="full")
    params = T.requires_grad(T.init(cfg, seed=0, device="cpu"))
    _, tb = _batch(cfg)
    layers = sum(n for _, n, comps in T._layer_plan(cfg)
                 if "attn" in comps) + cfg.enc_layers
    calls = []
    orig = ref.spinner_project_ref

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    ref.spinner_project_ref = counted
    try:
        loss, _ = T.loss_fn(params, cfg, tb)
        n_fwd = len(calls)
        torch.autograd.grad(loss, [t for t in tree_lib.leaves(params)
                                   if t.requires_grad])
    finally:
        ref.spinner_project_ref = orig
    assert layers == (0 if cfg.family == "ssm"
                      else cfg.n_layers + cfg.enc_layers)
    assert n_fwd == 2 * layers and len(calls) == 4 * layers


def test_adamw_blocks_of_a_large_leaf_give_the_same_update(monkeypatch):
    """A leaf past ``adamw.UPDATE_CHUNK`` elements is updated a block of
    leading-axis rows at a time (a stacked expert leaf would otherwise
    take several f32 copies of itself at once): params and moments
    bit-equal to the whole-leaf update, the gradient norm within f32
    rounding."""
    gen = torch.Generator().manual_seed(0)
    params = {"moe": {"wi": torch.randn((7, 4, 6, 5), generator=gen)},
              "norm": {"w": torch.randn((6,), generator=gen)}}
    grads = tree_lib.map(lambda t: torch.randn(t.shape, generator=gen),
                         params)
    out = []
    for chunk in (adamw.UPDATE_CHUNK, 2 * 4 * 6 * 5):
        monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
        p = tree_lib.map(torch.clone, params)
        s = adamw.init(p)
        for lr in (0.1, 0.05):
            p, s, stats = adamw.update(grads, s, p, lr)
        out.append((p, s, stats["grad_norm"]))
    assert len(adamw._blocks(params["moe"]["wi"])) == 4
    for a, b in zip(tree_lib.leaves(out[0][:2]), tree_lib.leaves(out[1][:2])):
        assert torch.equal(a, b)
    torch.testing.assert_close(out[0][2], out[1][2], rtol=1e-6, atol=0)

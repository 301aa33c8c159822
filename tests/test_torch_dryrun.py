"""``launch.dryrun`` on the CPU.

* Reduced cases: the reduced ``mistral-nemo-12b`` (2 layers, f32, full
  attention, remat "none"), as ``tests/test_system.py`` builds it: the
  port's analysis of its train (B = 4, L = 32), prefill and decode steps
  against the reference's ``hlo_analysis.analyze`` of the jitted step,
  compiled with no mesh. Flops are equal exactly. Bytes differ by
  construction (the port counts unfused eager operators, the reference
  fused HLO): train and prefill within [0.5, 3] of the reference's. The
  decode ratio is lower, 0.34: the reference's walk charges its layer
  scan's carried stacks (the stacked KV cache and params through the
  while loop's fusions, 4.1x the step's argument bytes), where the
  port's eager decode writes one row in place and reads each layer's
  slice once (1.4x its argument bytes).
* Full-width cells on meta: ``run_cell`` for qwen3-4b at all four
  shapes and one decode_32k cell of each other family: every cell ok,
  train flops at least 6 x params x tokens / chips.
* The smokes on the CPU: each ok; the pipeline smoke's serialized
  pipeline equals the reference's ``spinner.dumps``.

``repro.launch.dryrun`` is never imported here: at import it rewrites
``XLA_FLAGS`` to 512 host devices.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.core import spinner as jspinner
from repro.launch import hlo_analysis as JH
from repro.launch import steps as jsteps
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro_torch.configs import registry
from repro_torch.launch import cost_analysis as H
from repro_torch.launch import dryrun
from repro_torch.models import hooks

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

ARCH, B, L = "mistral-nemo-12b", 4, 32


def _reference(step):
    """The reference's ``hlo_analysis.analyze`` of the jitted reduced
    step, compiled with no mesh (``test_system.py:76``)."""
    jcfg = jregistry.reduced(ARCH)
    params = jax.eval_shape(lambda: jT.init(jax.random.PRNGKey(0), jcfg))
    if step == "train":
        opt = jax.eval_shape(lambda: jadamw.init(params))
        args = (params, opt, jax.ShapeDtypeStruct((), jnp.int32),
                jshapes.batch_specs(jcfg, B, L, training=True))
        fn = jsteps.make_train_step(jcfg)
    else:
        cache = jshapes.cache_specs(jcfg, B, L)
        if step == "prefill":
            fn = jsteps.make_prefill_step(jcfg)
            args = (params, jshapes.batch_specs(jcfg, B, L, training=False),
                    cache)
        else:
            fn = jsteps.make_serve_step(jcfg)
            args = (params, cache, jax.ShapeDtypeStruct((B, 1), jnp.int32))
    return JH.analyze(jax.jit(fn).lower(*args).compile().as_text())


@pytest.mark.parametrize("step,lo,hi", [("train", 0.5, 3.0),
                                        ("prefill", 0.5, 3.0),
                                        ("decode", 0.25, 0.5)])
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_reduced_analysis_matches_reference(step, lo, hi, device):
    cfg = registry.reduced(ARCH)
    assert (cfg.n_layers, cfg.dtype, cfg.attn_impl, cfg.remat) == \
        (2, "float32", "full", "none")
    fn, args = dryrun.step_call(cfg, step, B, L, device)
    got = H.analyze(fn, *args)
    want = _reference(step)
    assert got["flops"] == want["flops"]
    if step == "train":
        assert got["flops"] == 88_080_384
    ratio = got["bytes"] / want["bytes"]
    print(f"{step} on {device}: bytes port / reference = {ratio:.4f}")
    assert lo <= ratio <= hi
    assert H.roofline_terms(got)["t_roofline"] > 0


FULL_WIDTH = [("qwen3-4b", s) for s in jshapes.SHAPES] + [
    (a, "decode_32k") for a in ("mamba2-2.7b", "hymba-1.5b",
                                "moonshot-v1-16b-a3b",
                                "deepseek-v2-lite-16b", "qwen2-vl-2b",
                                "seamless-m4t-large-v2")]


@pytest.mark.parametrize("arch,shape", FULL_WIDTH)
def test_run_cell_full_width_on_meta(arch, shape):
    rec = dryrun.run_cell(arch, shape)
    assert rec["ok"], rec.get("traceback")
    assert rec["chips"] == 256 and rec["mesh"] == "data=16 x model=16"
    for k in ("flops", "bytes", "peak_bytes", "t_roofline", "arg_bytes",
              "param_bytes"):
        assert rec[k] > 0, k
    assert rec["peak_bytes"] >= rec["arg_bytes"]
    assert isinstance(rec["fits_hbm"], bool)
    if rec["step"] == "train":
        tokens = jshapes.SHAPES[shape].global_batch * \
            jshapes.SHAPES[shape].seq_len
        assert rec["flops"] >= 6 * rec["params"] * tokens / rec["chips"]
        assert rec["opt_bytes"] > 0
    else:
        assert rec["cache_bytes"] > 0
    assert hooks._fn is hooks._identity          # the constrainer reset


def test_run_cell_reports_a_failure():
    rec = dryrun.run_cell("qwen3-4b", "decode_32k",
                          overrides={"dtype": "nope"})
    assert rec["ok"] is False and "error" in rec
    assert hooks._fn is hooks._identity


def test_pipeline_smoke_matches_reference_dumps():
    rec = dryrun.pipeline_smoke(device="cpu")
    assert rec["ok"], rec
    want = jspinner.dumps(jspinner.chain(
        [jspinner.SpinnerBlock("circulant", 128, 128),
         jspinner.SpinnerBlock("toeplitz", 128, 128),
         jspinner.SpinnerBlock("skew_circulant", 256, 128)], f="relu"))
    assert rec["dumps"] == want


@pytest.mark.parametrize("smoke", ["serve_mesh", "serve_chaos",
                                   "serve_prefix", "serve_seeded"])
def test_serve_smokes_ok_on_cpu(smoke):
    rec = dryrun.SMOKES[smoke]("qwen3-4b", device="cpu")
    assert rec["ok"], rec


@pytest.mark.parametrize("argv,code", [
    (["--pipeline", "--device", "cpu"], 0),
    (["--arch", "qwen3-4b", "--shape", "long_500k"], 0),
    (["--arch", "qwen3-4b", "--shape", "long_500k", "--attn", "full",
      "--remat", "dots"], 0),
])
def test_cli(argv, code, capsys):
    assert dryrun.main(argv) == code
    assert '"ok": true' in capsys.readouterr().out


def test_cli_needs_a_cell_or_a_smoke():
    with pytest.raises(SystemExit):
        dryrun.main([])


def test_constrainer_records_each_role_and_returns_the_tensor():
    """``make_constrainer`` applies the reference's role rules on the
    production mesh: under an analysis it records each constrained
    activation's width (devices its spec splits it over), returns the
    tensor itself, and records nothing without an analysis or for a
    batch the data axis does not divide; ``hooks.reset`` restores the
    identity."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as M
    mesh = M.make_production_mesh(devices=[torch.device("meta")] * 256)
    fn = S.make_constrainer(mesh)
    cases = [((32, 8, 64), "activation", 16), ((32, 64, 8), "residual", 256),
             ((32, 7, 8), "residual", 16), ((32, 8, 160), "logits", 256),
             ((16, 32, 4, 8), "moe_buf", 256), ((1, 8, 64), "activation",
                                                None)]
    with H.Analysis() as a:
        for shape, role, _ in cases:
            x = torch.empty(shape, device="meta")
            assert fn(x, role) is x
    assert a.shares == [(role, shape, w) for shape, role, w in cases
                        if w is not None]
    hooks.set_constrainer(fn)
    hooks.reset()
    x = torch.empty(3)
    assert hooks.constrain(x, "activation") is x and \
        hooks._fn is hooks._identity


def test_named_gives_the_shard_shapes():
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as M
    mesh = M.make_production_mesh(multi_pod=True,
                                  devices=[torch.device("meta")] * 512)
    tree = S.named(mesh, {"w": S.P(None, "model"),
                          "x": [S.P(("pod", "data"), None), S.P()]})
    assert tree["w"].shard_shape((64, 128)) == (64, 8)
    assert tree["x"][0].shard_shape((64, 3)) == (2, 3)
    assert tree["x"][1].shard_shape(()) == ()
    with pytest.raises(ValueError):
        tree["w"].shard_shape((64, 12))

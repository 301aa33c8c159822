"""The five ``examples/torch_*.py`` on the CPU, run in process through
their ``main(argv)``, each held to its own invariant (and, where the
invariant is a pure function of shapes, to the reference example's):

* quickstart: the budgets of randomness t equal the reference's (pure
  functions of kind, n and m);
* kernel_approx: the estimation error falls from m = 16 to m = 1024 for
  every structure class and f;
* serve_lm: every request completes with its 16 tokens, under full KV
  and under SRF;
* train_lm: the loss falls (the reference example's assert);
* grad_compression_demo: the wire bytes, raw and compressed, equal the
  reference's ``compression.wire_bytes`` of the same params (8x fewer
  over the compressed leaves).
"""
import importlib.util
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import spinner as jspinner
from repro.models import transformer as jT
from repro.optim import compression as jC

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_budgets_equal_reference(capsys):
    out = _example("quickstart").main(["--device", "cpu"])
    want = {kind: jspinner.single(kind, m=512, n=128).budget
            for kind in ("circulant", "toeplitz", "unstructured")}
    want["circulant x3"] = jspinner.hd_chain("circulant", n=128, m=512,
                                             depth=3).budget
    assert out["budgets"] == want
    assert all(err == err for err in out["errors"].values())   # no NaN
    assert "budget of randomness" in capsys.readouterr().out


def test_kernel_approx_error_falls_with_m(capsys):
    mod = _example("kernel_approx")
    rows = mod.main(["--device", "cpu"])
    for kind in mod.KINDS:
        for f in mod.FNAMES:
            lo, hi = rows[(kind, f, mod.MS[0])][0], rows[(kind, f,
                                                          mod.MS[-1])][0]
            assert hi < lo, (kind, f, lo, hi)
    assert capsys.readouterr().out.startswith("kind,f,m,mean_abs_err,std")


def test_serve_lm_completes_every_request(capsys):
    out = _example("serve_lm").main(["--device", "cpu"])
    for attn, family in (("full", "kv"), ("srf", "srf")):
        r = out[attn]
        assert r["done"] == r["submitted"] == 16, attn
        assert r["max_new"] == [16] * 16 and r["family"] == family


def test_train_lm_loss_falls(tmp_path, capsys):
    out = _example("train_lm").main(["--device", "cpu", "--ckpt-dir",
                                     str(tmp_path)])
    assert out["final_step"] == 120
    assert out["log"][-1]["loss"] < out["log"][0]["loss"]


def test_grad_compression_wire_bytes_equal_reference(capsys):
    out = _example("grad_compression_demo").main(["--device", "cpu",
                                                  "--steps", "4"])
    jcfg = jregistry.reduced("qwen3-4b", n_layers=2)
    jparams = jax.eval_shape(lambda: jT.init(jax.random.PRNGKey(0), jcfg))
    cc = jC.CompressionConfig(chunk=4096, ratio=8, min_size=4096)
    assert (out["raw"], out["wire"]) == jC.wire_bytes(jparams, cc)
    assert out["raw"] / out["wire"] == pytest.approx(7.8, abs=0.05)
    assert len(out["exact"]) == len(out["compressed"]) == 4

"""The port's serving engine against ``repro.serving.Engine`` on the CPU,
and the port's isolation from jax and the reference package.

Greedy tokens must be IDENTICAL: reduced qwen3-4b with SRF attention,
the reference's params carried over with ``convert.params_from_jax``,
and the mixed-length request recipe of ``test_engine_parity._requests``.
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.serving import Engine, Request

ROOT = Path(__file__).resolve().parents[1]


def _requests(cls, cfg, n, seed=0):
    """test_engine_parity._requests's recipe (greedy, no enc-dec)."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab, int(
        rng.integers(2, 20))).astype(np.int32),
        max_new=int(rng.integers(3, 7))) for i in range(n)]


def _drive(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    for r in done:
        assert r.t_submit <= r.t_first <= r.t_done
        assert r.trace.monotonic() and r.trace.count("done") == 1
    return {r.uid: r.out_tokens for r in done}


@pytest.fixture(scope="module")
def models():
    jcfg = jregistry.reduced("qwen3-4b", attn_impl="srf", n_layers=2)
    cfg = registry.reduced("qwen3-4b", attn_impl="srf", n_layers=2)
    jparams = jT.init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    return jcfg, jparams, cfg, params


def test_greedy_tokens_identical_to_reference(models):
    jcfg, jparams, cfg, params = models
    want = _drive(JEngine(jcfg, jparams, batch_slots=4, max_len=64),
                  _requests(JRequest, jcfg, 8))
    eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    got = _drive(eng, _requests(Request, cfg, 8))
    assert len(got) == 8
    assert got == want
    assert eng.nonfinite_rows == 0
    assert eng.free_slots == eng.usable_slots        # every slot returned


def test_constant_state_zeroed_on_reuse(models):
    """A slot re-issued to a later request starts from zero: a second
    wave through the same engine matches a fresh engine."""
    _, _, cfg, params = models
    eng = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    _drive(eng, _requests(Request, cfg, 6, seed=1))
    got = _drive(eng, _requests(Request, cfg, 6, seed=2))
    fresh = Engine(cfg, params, batch_slots=4, max_len=64, device="cpu")
    assert got == _drive(fresh, _requests(Request, cfg, 6, seed=2))


def test_unported_requests_are_refused(models):
    _, _, cfg, params = models
    eng = Engine(cfg, params, batch_slots=2, max_len=64, device="cpu")
    prompt = np.arange(3, dtype=np.int32)
    with pytest.raises(NotImplementedError, match="sampling"):
        eng.submit(Request(uid=0, prompt=prompt, temperature=0.8))
    with pytest.raises(NotImplementedError, match="seeded"):
        eng.submit(Request(uid=1, prompt=prompt, embed_seed=7))
    with pytest.raises(NotImplementedError):
        Engine(cfg, params, device="cpu", quality_every=64)


def test_cli_full_width_by_default_and_reduced_opt_in(capsys):
    assert serve.parser().parse_args(["--arch", "qwen3-4b"]).reduced is False
    assert serve.main(["--arch", "qwen3-4b", "--attn", "srf", "--reduced",
                       "--device", "cpu", "--requests", "3",
                       "--prompt-len", "5", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=12" in out and "reduced=True" in out


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & {
        "jax", "jaxlib", "repro"}) for f in files}
    assert not {f: b for f, b in bad.items() if b}

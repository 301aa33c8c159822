"""``launch.cost_analysis``, the port's counterpart of
``launch.hlo_analysis`` (and of ``tests/test_hlo_analysis.py``): flops
of an eager call scale exactly with a Python loop of matrix products and
multiply through nested loops, the roofline terms over the H100
datasheet peaks, tensor byte counts; then what the byte mode counts for
views, functional and in-place operators, live bytes, the collectives,
and the custom kernels by formula (on meta an empty output, off the card
the plain version run unseen).
"""
import math

import pytest
import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops, ref
from repro_torch.launch import cost_analysis as H

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)


def _loop_model(ws, x):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("L", [1, 3, 8])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_flops_scale_with_trip_count(L, device):
    ws = torch.randn((L, 64, 64), device=device)
    x = torch.randn((32, 64), device=device)
    r = H.analyze(_loop_model, ws, x)
    assert r["flops"] == 2 * 32 * 64 * 64 * L


def test_nested_loop_trips_multiply():
    eye = torch.eye(16)

    def f(x):
        for _ in range(5):
            y = x
            for _ in range(3):
                y = torch.tanh(y @ eye)
            x = y
        return x
    r = H.analyze(f, torch.randn(8, 16))
    assert r["flops"] == 2 * 8 * 16 * 16 * 15


def test_roofline_terms():
    per_dev = {"flops": H.PEAK_FLOPS, "bytes": H.HBM_BW / 2,
               "collective_bytes": 0.0}
    t = H.roofline_terms(per_dev)
    assert t["t_compute"] == pytest.approx(1.0)
    assert t["t_memory"] == pytest.approx(0.5)
    assert t["bottleneck"] == "compute"
    assert (H.PEAK_FLOPS, H.HBM_BW, H.LINK_BW) == (989e12, 3.35e12, 450e9)
    t = H.roofline_terms({"flops": 0.0, "bytes": 0.0,
                          "collective_bytes": H.LINK_BW})
    assert t["t_collective"] == pytest.approx(1.0)
    assert t["bottleneck"] == "collective"


def test_tensor_bytes():
    assert H.tensor_bytes(torch.empty(128, 256)) == 128 * 256 * 4
    assert H.tensor_bytes(torch.empty(16, dtype=torch.bfloat16)) == 32
    assert H.unique_bytes((torch.empty(2, 2),
                           torch.empty(3, dtype=torch.int32))) == 16 + 12
    # an expanded view holds its storage, not its numel
    assert H.tensor_bytes(torch.empty(4).expand(1000, 4)) == 16
    a = torch.empty(10)
    assert H.unique_bytes({"a": a, "b": [a[2:], a.view(2, 5)]}) == 40


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_operator_bytes_and_live_peak(device):
    n = 1000
    a, b = torch.ones(n, device=device), torch.ones(n, device=device)

    assert H.analyze(lambda x: x.view(10, 100).t()[3:], a)["bytes"] == 0
    r = H.analyze(torch.add, a, b)
    assert r["bytes"] == 3 * 4 * n and r["peak_bytes"] == 4 * n
    c = torch.ones(n, device=device)
    assert H.analyze(lambda: c.add_(b))["bytes"] == 2 * 4 * n
    assert H.analyze(lambda: c.fill_(2.0))["bytes"] == 4 * n

    def chain(x):
        for _ in range(4):
            x = x * 2.0            # each product frees the one before
        return x
    r = H.analyze(chain, a)
    assert r["bytes"] == 4 * 2 * 4 * n
    assert r["peak_bytes"] == 2 * 4 * n
    assert r["arg_bytes"] == 4 * n and r["flops"] == 0


def test_collectives_count_per_device_bytes():
    axis = collectives.Axis("model", (torch.device("cpu"),) * 2)
    parts = [torch.ones(4, 8), torch.ones(4, 8)]
    with H.Analysis() as a:
        collectives.pmean(parts, axis)
        collectives.pmax(parts, axis)
        collectives.stitch_heads(parts, axis, head_dim=1)
    r = a.result()
    assert r["coll/all-reduce"] == 2 * 2 * 4 * 8 * 4
    assert r["coll/all-gather"] == 4 * 16 * 4
    assert r["collective_bytes"] == r["coll/all-reduce"] + r["coll/all-gather"]
    assert r["collective_count"] == 3


def test_kernels_count_by_formula():
    """Each dispatcher adds its kernel's formula and no aten operator of
    its plain version: on meta an empty output of the kernel's shape, on
    the CPU the plain version's result."""
    rows, n = 12, 64
    for device in ("cpu", "meta"):
        x = torch.randn(rows, n) if device == "cpu" else \
            torch.empty(rows, n, device="meta")
        with H.Analysis() as a:
            y = ops.fwht(x)
        r = a.result()
        assert y.shape == x.shape and y.device.type == device
        assert (r["flops"], r["bytes"]) == kcost.fwht(rows, n, 4)
        assert r["kernel/fwht"] == 1 and r["peak_bytes"] == rows * n * 4
        if device == "cpu":
            torch.testing.assert_close(y, ref.fwht_ref(x))
    pool = torch.randn(9, 16, 32)
    tables = torch.tensor([[1, 2], [3, 0]])
    with H.Analysis() as a:
        got = ops.paged_gather(pool, tables)
    assert torch.equal(got, ref.paged_gather_ref(pool, tables))
    assert a.result()["bytes"] == kcost.gather(2 * 2 * 16, 32, 4)[1]


def test_pair_gather_counts_both_pools():
    """paged_gather_kv counts the two pools' gathers (rows of 32 and of
    8), on meta an empty output of each pool's shape."""
    tables = torch.tensor([[1, 2], [3, 0]])
    want = kcost.gather(2 * 2 * 16, 32, 4)[1] + \
        kcost.gather(2 * 2 * 16, 8, 4)[1]
    for device in ("cpu", "meta"):
        a, b = (torch.randn(9, 16, d, device=device) for d in (32, 8))
        with H.Analysis() as an:
            got = ops.paged_gather_kv(a, b, tables)
        r = an.result()
        assert (r["flops"], r["bytes"]) == (0.0, want)
        assert r["kernel/paged_gather_kv"] == 1
        assert [g.shape for g in got] == [(2, 32, 32), (2, 32, 8)]
        if device == "cpu":
            for g, pool in zip(got, (a, b)):
                assert torch.equal(g, ref.paged_gather_ref(pool, tables))


def _paged_step_result(cfg, params):
    """The cost analysis of one paged step (a chunk of 3 tokens on 2
    rows) of ``cfg``."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import paged_cache
    pools = paged_cache.init_pools(cfg, 9, 4, num_slots=4, device="cpu")
    tok = torch.arange(6).reshape(2, 3)
    return H.analyze(lambda: T.paged_step(
        params, cfg, pools, tok, torch.arange(3).repeat(2, 1),
        torch.ones(2, 3, dtype=torch.bool), torch.tensor([[1, 2], [3, 4]]),
        torch.tensor([1, 2])))


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-v2-lite-16b"],
                         ids=["full KV", "MLA"])
def test_paged_step_bytes_equal_the_two_single_gathers(arch, monkeypatch):
    """A layer's two pools gathered in one launch cost the bytes of the
    two single-pool gathers the attention made before: the paged step's
    analysis is the same but for the kernel counts."""
    from repro_torch.configs import registry
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    cfg = registry.reduced(arch)
    params = T.init(cfg, seed=0, device="cpu")
    pair = _paged_step_result(cfg, params)
    monkeypatch.setattr(attention, "_paged_hist_kv", lambda a, b, t: (
        attention._paged_hist(a, t), attention._paged_hist(b, t)))
    single = _paged_step_result(cfg, params)
    assert pair["kernel/paged_gather_kv"] == cfg.n_layers
    assert single["kernel/paged_gather"] == 2 * cfg.n_layers
    for key in ("flops", "bytes", "peak_bytes"):
        assert pair[key] == single[key], key


def test_decode_cell_bytes_unchanged():
    """qwen3-4b's decode_32k dry-run cell on meta: the flops and bytes it
    counted before a layer's K and V went through one gather launch."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen3-4b", "decode_32k")
    assert rec["ok"], rec.get("traceback")
    assert (rec["global_flops"], rec["global_bytes"]) == (3503686680576.0,
                                                          7929189463252.0)


def test_spinner_counts_forward_by_formula_and_backward_op_by_op():
    """Under an analysis the spinner runs its autograd Function on any
    device: the forward by formula, the plain VJP backward counted op by
    op (as training on the card runs it)."""
    from repro_torch.core import spinner
    gsz, bsz, n, m = 2, 8, 16, 32
    pipe = spinner.single("circulant", m=m, n=n)
    gen = torch.Generator().manual_seed(0)
    params = pipe.init(gen)
    g = torch.stack([params[0]["g"]] * gsz).requires_grad_(True)
    p = {"g": g, "d0": torch.stack([params[0]["d0"]] * gsz),
         "d1": torch.stack([params[0]["d1"]] * gsz)}
    x = torch.randn(gsz, bsz, n, generator=gen, requires_grad=True)
    want = ops.spinner_project("circulant", p, x, m, grouped=True)
    with H.Analysis() as a:
        y = ops.spinner_project("circulant", p, x, m, grouped=True)
        fwd = a.result()
        y.sum().backward()
    r = a.result()
    ops_, byts = kcost.spinner("circulant", gsz, bsz, n, m, 4, g[0].numel(),
                               m, True)
    assert fwd["kernel_flops"] == ops_ and fwd["kernel/spinner_project"] == 1
    assert fwd["bytes"] == byts
    torch.testing.assert_close(y, want)
    assert r["bytes"] > byts and x.grad is not None
    assert kcost.OPS_PER_NORMAL == 155 and kcost.OPS_PER_SIGN == 116
    assert math.isclose(kcost.seeded("circulant", 1, 1, n, m, 4, m)[0],
                        kcost.spinner("circulant", 1, 1, n, m, 4, 0, m)[0]
                        + 32 * 155 + 2 * n * 116)

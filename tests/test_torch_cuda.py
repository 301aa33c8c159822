"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU these tests skip (the last test,
the dispatchers' gradients on the CPU, runs everywhere). On the card
(no jax there, so the repository's conftest is bypassed):

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

The two spinner ops differentiate on the card (kernel forward, plain
VJP backward); the other five dispatchers refuse an input that requires
grad. Tolerances: spinner, seeded spinner and srf_decode f32 max|kernel -
plain| <= 1e-4 * max|plain|, bf16 2e-2 (the sign epilogue where |y| is
beyond f32 summation-order noise of 0); the paged gathers bit for bit
(torch.equal), and the f32 seeded spinner bit for bit against the
materialized spinner kernel on the params regenerated on the card; fwht
and circulant_project elementwise within ``tests/test_kernels.py``'s
``_tol`` (f32 rtol = atol = 2e-5; bf16 2e-2, and for exp and cos_sin
rtol 5e-2, atol 0.15, exp compared in log space).
This file imports torch and the port only.
"""
import importlib

import pytest
import torch

from repro_torch.kernels import circulant as kcirc
from repro_torch.kernels import ops, ref
from repro_torch.kernels import spinner as kspin

# ``repro_torch.kernels`` re-exports the ops ``fwht``, ``paged_gather`` and
# ``srf_decode`` over the modules of the same names
kfwht = importlib.import_module("repro_torch.kernels.fwht")
kpg = importlib.import_module("repro_torch.kernels.paged_gather")
kdec = importlib.import_module("repro_torch.kernels.srf_decode")


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see the module docstring)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    """Both CUDA kernels against their plain versions on the card, f32
    (1e-4 of the largest value) and bf16 (2e-2)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for kind in kspin.KERNEL_KINDS:
        for epi in ("identity", "exp", "cos_sin", "relu"):
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                gsz, bsz, n, m = 3, 13, 64, 200
                x = (torch.randn((gsz, bsz, n), generator=gen,
                                 device=cuda_device) * n ** -0.25).to(dtype)
                g = torch.randn(kspin._gen_shape(kind, gsz, n, m),
                                generator=gen, device=cuda_device).to(dtype)
                d = (2 * torch.randint(0, 2, (2, gsz, n), generator=gen,
                                       device=cuda_device) - 1).to(dtype)
                k = kspin.spinner_project_cuda(kind, g, x, m, d0=d[0],
                                               d1=d[1], epilogue=epi)
                p = ref.spinner_project_ref(kind, g, x, m, d0=d[0], d1=d[1],
                                            epilogue=epi)
                err = (k.float() - p.float()).abs().max().item()
                assert err <= tol * p.float().abs().max().item(), \
                    (kind, epi, dtype, err)
    for b, h, m, dv in ((2, 4, 32, 16), (2, 3, 37, 13)):
        s = torch.randn((b, h, m, dv), device=cuda_device)
        z, pq, pk = (torch.rand((b, h, m), device=cuda_device)
                     for _ in range(3))
        v = torch.randn((b, h, dv), device=cuda_device)
        want = ref.srf_decode_ref(s, z, pq, pk, v)
        got = kdec.srf_decode_cuda(s.clone(), z.clone(), pq, pk, v)
        for gt, wt in zip(got, want):
            assert (gt - wt).abs().max() <= 1e-4 * wt.abs().max()


def _offset_view(t: torch.Tensor, elems: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base lies ``elems`` elements past
    an allocation's start (so not 16-byte aligned unless 0)."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    view = buf[elems:].view(t.shape)
    view.copy_(t)
    return view


def _dequant_path(pool, scales, tables, out, n_pools=1):
    n, p, d = pool.shape
    return kpg.dequant_plan(p, d, n_pools, tables.numel(),
                            pool.data_ptr() % 16, 0, out,
                            scales_addr_mod16=scales.data_ptr() % 16,
                            n_pages=n, sms=torch.cuda.get_device_properties(
                                pool.device).multi_processor_count).path


@pytest.mark.cuda
def test_paged_gathers_bit_equal_on_card(cuda_device):
    """paged_gather (bf16, f32, int8 pools) and paged_gather_dequant
    (int8 -> bf16, f32; one pool, and a layer's K and V in one launch)
    against their plain versions, bit for bit: aligned shapes (the TMA
    path), a page of 64 rows cut into chunks, rows of 32768 cut into
    pieces, ragged row widths, pool views off 16-byte alignment (the
    vector and scalar paths), ids out of range on both sides, int32 and
    int64 tables."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for n, p, d, r, m in ((33, 16, 64, 4, 8), (9, 64, 1024, 3, 4),
                          (5, 4, 32768, 2, 3), (7, 3, 13, 3, 5),
                          (9, 2, 1, 5, 2)):
        tables = torch.randint(-2, n + 2, (r, m), generator=gen,
                               device=cuda_device)
        for dtype in (torch.bfloat16, torch.float32, torch.int8):
            pool = torch.randn((n, p, d), generator=gen,
                               device=cuda_device).mul(50).to(dtype)
            before = kpg.paged_gather_cuda.launches
            got = ops.paged_gather(pool, tables)
            assert kpg.paged_gather_cuda.launches == before + 1
            assert torch.equal(got, ref.paged_gather_ref(pool, tables))
        q = torch.randint(-127, 128, (2, n, p, d), generator=gen,
                          device=cuda_device, dtype=torch.int8)
        sc = torch.rand((2, n, p, 1), generator=gen, device=cuda_device)
        views = [(q[0], sc[0], q[1], sc[1])]
        if d % 16 == 0:
            assert _dequant_path(q[0], sc[0], tables, torch.bfloat16) == \
                "tma"
            views += [tuple(_offset_view(t, o) for t, o in
                            zip((q[0], sc[0], q[1], sc[1]), offs))
                      for offs in ((8, 0, 0, 0), (1, 0, 1, 0),
                                   (0, 1, 0, 0))]
            assert [_dequant_path(v[0], v[1], tables, torch.bfloat16)
                    for v in views[1:]] == ["vector", "scalar", "vector"]
        for kq, ks, vq, vs in views:
            for tdt in (torch.int64, torch.int32):
                t = tables.to(tdt)
                for out in (torch.bfloat16, torch.float32):
                    want_k = ref.paged_gather_dequant_ref(kq, ks, t, out)
                    want_v = ref.paged_gather_dequant_ref(vq, vs, t, out)
                    before = kpg.paged_gather_dequant_cuda.launches
                    got = ops.paged_gather_dequant(kq, ks, t, out)
                    assert kpg.paged_gather_dequant_cuda.launches == \
                        before + 1
                    assert got.dtype == out and torch.equal(got, want_k)
                    before = kpg.paged_gather_dequant_kv_cuda.launches
                    got_k, got_v = ops.paged_gather_dequant_kv(
                        kq, ks, vq, vs, t, out)
                    assert kpg.paged_gather_dequant_kv_cuda.launches == \
                        before + 1
                    assert torch.equal(got_k, want_k), (n, p, d, tdt, out)
                    assert torch.equal(got_v, want_v), (n, p, d, tdt, out)


@pytest.mark.cuda
def test_core_init_lands_on_generator_device(cuda_device):
    """With no device given, core params land on a CUDA generator's
    device."""
    from repro_torch.core import spinner, srf_attention, structured
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pipe = spinner.SpinnerPipeline((spinner.SpinnerBlock(
        kind="circulant", m=16, n=8, use_hd=True),), f="identity")
    leaves = list(pipe.init(gen)[0].values())
    leaves += list(structured.init(gen, "toeplitz", 8, 8).values())
    leaves += [t for blk in srf_attention.init(
        gen, srf_attention.SRFConfig(n_features=16, head_dim=8), 2)
        for t in blk.values()]
    assert leaves and all(t.is_cuda for t in leaves)


@pytest.mark.cuda
def test_seeded_kernel_matches_plain_and_materialized_on_card(cuda_device):
    """The seeded spinner kernel, every kind x {identity, exp, cos_sin},
    against its plain version (f32 1e-4, bf16 2e-2 of the largest value)
    and, in f32, bit for bit against the materialized kernel run on
    ``seedgen.grouped_params`` computed on the card; the (head, request)
    serving shape through ``ops`` launches the kernel once."""
    from repro_torch.kernels import seedgen
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    gsz, bsz, n, m = 3, 13, 64, 200
    for kind in kspin.KERNEL_KINDS:
        for epi in ("identity", "exp", "cos_sin"):
            seeds = torch.randint(0, 2 ** 32, (gsz,), generator=gen,
                                  device=cuda_device, dtype=torch.int64)
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                x = (torch.randn((gsz, bsz, n), generator=gen,
                                 device=cuda_device) * n ** -0.25).to(dtype)
                k = kspin.spinner_project_seeded_cuda(kind, seeds, x, m,
                                                      epilogue=epi)
                p = ref.spinner_project_seeded_ref(kind, seeds, x, m,
                                                   epilogue=epi)
                err = (k.float() - p.float()).abs().max().item()
                assert err <= tol * p.float().abs().max().item(), \
                    (kind, epi, dtype, err)
                if dtype == torch.float32:
                    gp = seedgen.grouped_params(kind, n, m, seeds)
                    twin = kspin.spinner_project_cuda(
                        kind, gp["g"].contiguous(), x, m, d0=gp["d0"],
                        d1=gp["d1"], epilogue=epi)
                    assert torch.equal(k, twin), (kind, epi)
    x = torch.randn((64, 4, 128), device=cuda_device)
    before = kspin.spinner_project_seeded_cuda.launches
    y = ops.spinner_project_seeded("circulant", torch.arange(
        64, device=cuda_device), x, 256, grouped=True)
    assert y.shape == (64, 4, 256) and torch.isfinite(y).all()
    assert kspin.spinner_project_seeded_cuda.launches == before + 1


def _tol(dtype, epilogue="identity"):
    """``tests/test_kernels.py:_tol``."""
    if dtype == torch.bfloat16:
        if epilogue in ("cos_sin", "exp"):
            return dict(rtol=5e-2, atol=1.5e-1)
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_fwht_and_circulant_match_plain_on_card(cuda_device):
    """ops.fwht and ops.circulant_project launch their kernels once a
    call and agree with the plain versions on the card; an fwht above
    the kernel's n goes to the plain version and is counted."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for b, n in ((4, 64), (300, 32), (1, 1), (3, 16384)):
        for dtype in (torch.float32, torch.bfloat16):
            for normalized in (True, False):
                x = torch.randn((b, n), generator=gen,
                                device=cuda_device).to(dtype)
                before = kfwht.fwht_cuda.launches
                got = ops.fwht(x, normalized)
                assert kfwht.fwht_cuda.launches == before + 1
                torch.testing.assert_close(
                    got.float(), ref.fwht_ref(x, normalized).float(),
                    **_tol(dtype))
    plain = ops.fwht.plain_calls
    x = torch.randn((2, 2 * kfwht.MAX_N), generator=gen, device=cuda_device)
    torch.testing.assert_close(ops.fwht(x), ref.fwht_ref(x))
    assert ops.fwht.plain_calls == plain + 1
    for nb, n, b, m in ((2, 32, 8, 48), (1, 128, 300, 100), (3, 20, 5, 60)):
        for epi in kcirc.EPILOGUES:
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.randn((nb, n), generator=gen,
                                device=cuda_device).to(dtype)
                x = (torch.randn((b, n), generator=gen, device=cuda_device)
                     * 0.3).to(dtype)
                sq = 0.5 * (x.float() ** 2).sum(-1) if epi == "exp" else None
                before = kcirc.circulant_project_cuda.launches
                got = ops.circulant_project(g, x, m, epi, sq).float()
                assert kcirc.circulant_project_cuda.launches == before + 1
                want = ref.circulant_project_ref(g, x, m, epi, sq).float()
                if epi == "exp":
                    got, want = got.log(), want.log()
                if epi == "heaviside":
                    y = ref.circulant_project_ref(g, x, m).float()
                    far = y.abs() > 1e-3
                    got, want = got[far], want[far]
                torch.testing.assert_close(got, want, **_tol(dtype, epi))


# Ragged shapes aimed at the circulant kernel's tile rules (BM = BN = 128
# output rows and columns a block, chunks of BK = 32 input columns):
# (nb, n, B, m). n < BN and n < BK; n not a multiple of BK; m not a
# multiple of BN; tiles that cross a generator block (n = 160, 200) next
# to window tiles (n = 256, 1024); B = 1; n = 1000 (rows 16-byte aligned
# in both dtypes, a tile crossing each block boundary) and rows that are
# not 16-byte aligned (n = 70 in both dtypes, n = 12 in bf16).
CIRC_RAGGED = [(2, 16, 8, 32), (3, 40, 7, 120), (3, 160, 130, 400),
               (2, 200, 33, 330), (2, 256, 5, 384), (1, 1024, 1, 1000),
               (2, 1000, 9, 1500), (2, 70, 17, 140), (3, 12, 6, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n,b,m", CIRC_RAGGED)
def test_circulant_ragged_tiles_on_card(cuda_device, nb, n, b, m):
    """The tensor-core circulant kernel on the ragged shapes above, every
    epilogue, f32 and bf16, against ``ref.circulant_project_ref`` within
    ``_tol`` (exp in log space, heaviside where |y| > 1e-3); then once
    more from an x whose base is not 16-byte aligned."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn((nb, n), generator=gen, device=cuda_device).to(dtype)
        x = (torch.randn((b, n), generator=gen, device=cuda_device)
             * 0.3).to(dtype)
        sq = 0.5 * (x.float() ** 2).sum(-1)
        y = ref.circulant_project_ref(g, x, m).float()
        for epi in kcirc.EPILOGUES:
            got = kcirc.circulant_project_cuda(g, x, m, epi, sq).float()
            want = ref.circulant_project_ref(g, x, m, epi, sq).float()
            if epi == "exp":
                got, want = got.log(), want.log()
            if epi == "heaviside":
                far = y.abs() > 1e-3
                got, want = got[far], want[far]
            torch.testing.assert_close(got, want, **_tol(dtype, epi),
                                       msg=lambda s: f"{epi} {dtype}: {s}")
        flat = torch.zeros(b * n + 1, dtype=dtype, device=cuda_device)
        shifted = flat[1:].view(b, n)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 != 0
        torch.testing.assert_close(
            kcirc.circulant_project_cuda(g, shifted, m).float(), y,
            **_tol(dtype))


# Ragged shapes aimed at the spinner kernels' routes and tile rules
# (window_mma.cuh: BN = 128 output columns a block, chunks of BK = 32;
# rows resident up to n = 128, a pre-pass above): (G, B, n, m, use_hd).
# n < BK with no HD (n = 12, circulant tiles built: n < BN); HD at n = 64
# with m crossing generator blocks; n = 160 without HD (x streamed, n not
# a multiple of BK, circulant tiles crossing blocks); the pre-pass at
# n = 256 and 1024, B = 1, m not a multiple of BN; and B = 130 rows past
# one 128-row tile.
SPIN_RAGGED = [(2, 1, 12, 40, False), (3, 5, 64, 200, True),
               (1, 33, 160, 400, False), (2, 7, 256, 300, True),
               (1, 1, 1024, 1000, True), (1, 130, 1024, 1300, True)]
SPIN_EPIS = ("identity", "exp", "sign", "cos_sin")


def _spin_close(k, p, y, epi, tol):
    """max|k - p| <= tol * max|p|; sign compared where |y| is beyond f32
    summation-order noise of the step."""
    k, p = k.float(), p.float()
    if epi == "sign":
        far = (y.abs() > 1e-4 * y.abs().max()).expand_as(p)
        k, p = k[far], p[far]
    assert torch.isfinite(k).all()
    return (k - p).abs().max().item() <= tol * p.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("gsz,bsz,n,m,use_hd", SPIN_RAGGED)
def test_spinner_ragged_routes_on_card(cuda_device, gsz, bsz, n, m, use_hd):
    """Both spinner kernels on the ragged shapes above, every kernel kind,
    identity / exp / sign / cos_sin, f32 (1e-4 of the largest value) and
    bf16 (2e-2) against their plain versions; the f32 seeded kernel bit
    for bit against the materialized kernel on the params regenerated on
    the card. No HD at n = 160: also from an x whose base is not 16-byte
    aligned (plain loads instead of cp.async)."""
    from repro_torch.kernels import seedgen
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    for kind in kspin.KERNEL_KINDS:
        seeds = torch.randint(0, 2 ** 32, (gsz,), generator=gen,
                              device=cuda_device, dtype=torch.int64)
        gp = seedgen.grouped_params(kind, n, m, seeds, use_hd=use_hd)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x = (torch.randn((gsz, bsz, n), generator=gen,
                             device=cuda_device) * n ** -0.25).to(dtype)
            p = {k: v.to(dtype) for k, v in gp.items()}
            hd = dict(d0=p["d0"], d1=p["d1"]) if use_hd else {}
            y = ref.spinner_project_ref(kind, gp["g"], x.float(), m,
                                        d0=gp.get("d0"), d1=gp.get("d1"))
            for epi in SPIN_EPIS:
                kw = dict(epilogue=epi, y_scale=0.9, out_scale=m ** -0.5)
                k = kspin.spinner_project_cuda(kind, p["g"].contiguous(),
                                               x, m, **hd, **kw)
                want = ref.spinner_project_ref(kind, p["g"], x, m, **hd,
                                               **kw)
                assert _spin_close(k, want, y, epi, tol), \
                    (kind, epi, dtype, "materialized")
                s = kspin.spinner_project_seeded_cuda(kind, seeds, x, m,
                                                      use_hd=use_hd, **kw)
                want = ref.spinner_project_seeded_ref(kind, seeds, x, m,
                                                      use_hd=use_hd, **kw)
                assert _spin_close(s, want, y, epi, tol), \
                    (kind, epi, dtype, "seeded")
                if dtype == torch.float32:
                    assert torch.equal(s, k), (kind, epi)
            if n == 160:
                flat = torch.zeros(x.numel() + 1, dtype=dtype,
                                   device=cuda_device)
                shifted = flat[1:].view(x.shape)
                shifted.copy_(x)
                assert shifted.data_ptr() % 16 != 0
                torch.testing.assert_close(
                    kspin.spinner_project_cuda(kind, p["g"].contiguous(),
                                               shifted, m),
                    kspin.spinner_project_cuda(kind, p["g"].contiguous(),
                                               x, m))


def _grad_cases(dev):
    """(name, call) for every kernels.ops dispatcher, each with one CUDA
    input that requires grad."""
    def leaf(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, dtype=dtype).requires_grad_()
    params = {"g": torch.randn((1, 64), device=dev),
              "d0": torch.ones(64, device=dev),
              "d1": torch.ones(64, device=dev)}
    pool = torch.randint(-127, 128, (5, 4, 8), device=dev,
                         dtype=torch.int8)
    ones = torch.ones((5, 4, 1), device=dev)
    tables = torch.randint(0, 5, (2, 3), device=dev)
    s, z = torch.zeros((1, 2, 16, 8), device=dev), torch.zeros(
        (1, 2, 16), device=dev)
    return [
        ("spinner_project", lambda: ops.spinner_project(
            "circulant", params, leaf(3, 64), 64)),
        ("spinner_project_seeded", lambda: ops.spinner_project_seeded(
            "circulant", 7, leaf(3, 64), 64)),
        ("srf_decode", lambda: ops.srf_decode(
            s.clone(), z.clone(), leaf(1, 2, 16), torch.rand(
                (1, 2, 16), device=dev), torch.randn((1, 2, 8), device=dev))),
        ("paged_gather", lambda: ops.paged_gather(leaf(5, 4, 8), tables)),
        ("paged_gather_dequant", lambda: ops.paged_gather_dequant(
            pool, leaf(5, 4, 1), tables)),
        ("paged_gather_dequant_kv", lambda: ops.paged_gather_dequant_kv(
            pool, ones, pool, leaf(5, 4, 1), tables)),
        ("fwht", lambda: ops.fwht(leaf(3, 64))),
        ("circulant_project", lambda: ops.circulant_project(
            torch.randn((2, 32), device=dev), leaf(3, 32), 48)),
    ]


GRAD_OPS = ("spinner_project", "spinner_project_seeded")


@pytest.mark.cuda
def test_dispatchers_refuse_grad_on_card(cuda_device):
    """The two spinner ops take a CUDA input that requires grad: their
    kernel runs forward and the gradient flows (through the plain
    version's VJP). Every other kernels.ops dispatcher raises on one
    while grad mode is on (those kernels have no backward, nor have the
    reference's), and launches its kernel under torch.no_grad()."""
    cases = _grad_cases(cuda_device)
    assert len(cases) == 8
    for name, call in cases:
        if name in GRAD_OPS:
            ops.reset_counts()
            out = call()
            assert out.is_cuda and out.requires_grad, name
            out.float().sum().backward()
            counts = ops.launch_counts()
            key = "spinner_seeded" if "seeded" in name else "spinner"
            assert counts[key] == 1 and counts[key + "_bwd"] == 1, counts
            assert counts["spinner_plain_on_cuda"] == 0, counts
            assert counts["spinner_seeded_plain_on_cuda"] == 0, counts
            continue
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            out = call()
        out = out[-1] if isinstance(out, tuple) else out
        assert out.is_cuda and not out.requires_grad, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,epi", [("circulant", "exp"),
                                      ("circulant", "identity"),
                                      ("toeplitz", "cos_sin"),
                                      ("hankel", "relu")])
def test_spinner_grads_on_card_equal_plain(cuda_device, kind, epi, dtype):
    """The kernel-forward Functions' gradients against the plain
    version's on the card: f32 within 1e-4 of the largest value (the
    forward outputs that the backward's cotangent sees agree to the
    kernel tolerance; the backward itself is the plain VJP), bf16 2e-2;
    seeded: d/dx."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    gsz, bsz, n, m = 3, 40, 128, 256
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    x = (torch.randn((gsz, bsz, n), generator=gen, device=cuda_device)
         * n ** -0.25).to(dtype)
    g = torch.randn(kspin._gen_shape(kind, gsz, n, m), generator=gen,
                    device=cuda_device).to(dtype)
    d = (2 * torch.randint(0, 2, (2, gsz, n), generator=gen,
                           device=cuda_device) - 1).to(dtype)
    kw = dict(epilogue=epi, out_scale=m ** -0.5)
    dy = torch.randn((gsz, bsz, 2 * m if epi == "cos_sin" else m),
                     generator=gen, device=cuda_device).to(dtype)

    def grads(route_cuda, seeded=False):
        leaves = [t.clone().requires_grad_() for t in (x, g, d[0], d[1])]
        if seeded:
            seeds = torch.tensor([3, 4, 5], device=cuda_device)
            if route_cuda:
                y = ops.spinner_project_seeded(kind, seeds, leaves[0], m,
                                               grouped=True, **kw)
            else:
                y = ref.spinner_project_seeded_ref(kind, seeds, leaves[0],
                                                   m, **kw)
            return torch.autograd.grad(y, leaves[:1], dy)
        p = dict(zip(("g", "d0", "d1"), leaves[1:]))
        if route_cuda:
            y = ops.spinner_project(kind, p, leaves[0], m, grouped=True, **kw)
        else:
            y = ref.spinner_project_ref(kind, p["g"], leaves[0], m,
                                        d0=p["d0"], d1=p["d1"], **kw)
        return torch.autograd.grad(y, leaves, dy)
    for seeded in (False, True):
        ops.reset_counts()
        got = grads(True, seeded)
        counts = ops.launch_counts()
        key = "spinner_seeded" if seeded else "spinner"
        assert counts[key] == 1 and counts[key + "_bwd"] == 1, counts
        for a, b in zip(got, grads(False, seeded)):
            assert a.dtype == b.dtype and torch.isfinite(a).all()
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * b.float().abs().max().item(), \
                (kind, epi, dtype, seeded, err)


def _legacy_module():
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving import legacy
    return legacy


LEGACY_CELLS = [("full", {}, False), ("int8", {"kv_cache_dtype": "int8"},
                                       False),
                ("srf", {"attn_impl": "srf"}, False),
                ("seeded", {"attn_impl": "srf"}, True)]


def _legacy_traffic(cfg, temperature):
    """8 mixed-length requests (test_engine_parity's recipe)."""
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(
        rng.integers(2, 20))).astype(np.int32),
        max_new=int(rng.integers(3, 7)), temperature=temperature)
        for i in range(8)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,over,seeded", LEGACY_CELLS,
                         ids=[c[0] for c in LEGACY_CELLS])
def test_legacy_on_card_equals_cpu_and_paged(cuda_device, cell, over,
                                             seeded):
    """Reduced qwen3-4b (f32, 2 layers): the legacy engine's tokens on the
    card equal its tokens on the CPU, greedy and sampled; and on the card
    the paged engine gives the legacy engine's tokens (int8: greedy)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, PagedConfig
    legacy = _legacy_module()
    cfg = registry.reduced("qwen3-4b", n_layers=2, **over)
    if seeded:
        cfg = dataclasses.replace(cfg, srf=dataclasses.replace(
            cfg.srf, seeded=True))
    cpu = T.init(cfg, seed=3, device="cpu")
    card = _to(cpu, cuda_device)

    def drive(eng, reqs):
        for r in reqs:
            eng.submit(r)
        return {r.uid: r.out_tokens for r in eng.run()}
    for t in (0.0, 0.8):
        got = {}
        for dev, params in (("cpu", cpu), ("cuda", card)):
            got[dev] = drive(legacy.Engine(cfg, params, batch_slots=4,
                                           max_len=64, seed=5, device=dev),
                             _legacy_traffic(cfg, t))
        assert len(got["cuda"]) == 8 and got["cuda"] == got["cpu"], (cell, t)
        if cell == "int8" and t > 0:
            continue
        paged = drive(Engine(cfg, card, batch_slots=4, max_len=64, seed=5,
                             device=cuda_device,
                             paged=PagedConfig(quantize_kv=cell == "int8")),
                      _legacy_traffic(cfg, t))
        assert paged == got["cuda"], (cell, t)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("attn,quant", [("srf", False), ("full", False),
                                        ("full", True)])
def test_kernel_timing_counts_equal_launches_on_card(cuda_device, attn,
                                                     quant):
    """A reduced paged serve run on the card with kernel timing on: one
    kernel_dispatch_seconds series per kernel the run launched, each
    count equal to that kernel's launch counter; the tokens equal the
    run's with timing off. Under CUDA-graph capture nothing is timed."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.obs import MetricsRegistry, profiling
    from repro_torch.serving import Engine, PagedConfig
    cfg = registry.reduced("qwen3-4b", n_layers=2, attn_impl=attn)
    params = T.init(cfg, seed=1, device=cuda_device)
    names = {"spinner": "spinner_project",
             "spinner_seeded": "spinner_project_seeded",
             "srf_decode": "srf_decode", "paged_gather": "paged_gather",
             "paged_gather_dequant": "paged_gather_dequant",
             "paged_gather_dequant_kv": "paged_gather_dequant_kv",
             "fwht": "fwht", "circulant_project": "circulant_project"}

    def run():
        eng = Engine(cfg, params, batch_slots=4, max_len=64,
                     device=cuda_device,
                     paged=PagedConfig(quantize_kv=quant))
        for r in _legacy_traffic(cfg, 0.0):
            eng.submit(r)
        return {r.uid: r.out_tokens for r in eng.run()}
    ops.reset_counts()
    off = run()
    reg = MetricsRegistry()
    ops.reset_counts()
    try:
        profiling.enable_kernel_timing(reg)
        on = run()
    finally:
        profiling.disable_kernel_timing()
    counts = ops.launch_counts()
    assert on == off
    hist = reg.snapshot()["histograms"]["kernel_dispatch_seconds"]
    launched = {names[k]: n for k, n in counts.items() if k in names and n}
    assert launched and set(hist) == {f'kernel="{k}"' for k in launched}
    for k, n in launched.items():
        assert hist[f'kernel="{k}"']["count"] == n, (k, n, hist)

    x = torch.randn(64, 256, device=cuda_device)
    ops.fwht(x)                                   # build and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        profiling.enable_kernel_timing(reg)
        with torch.cuda.graph(graph):
            y = ops.fwht(x)
    finally:
        profiling.disable_kernel_timing()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.allclose(y, ops.fwht(x), rtol=1e-5, atol=1e-5)
    assert 'kernel="fwht"' not in reg.snapshot()["histograms"][
        "kernel_dispatch_seconds"]


def test_dispatchers_differentiate_on_cpu():
    """On the CPU the same calls take the plain versions, which keep
    their gradients (no card needed: this test runs everywhere)."""
    for name, call in _grad_cases(torch.device("cpu")):
        out = call()
        out = out[-1] if isinstance(out, tuple) else out
        assert out.requires_grad, name
        out.float().sum().backward()

"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips. On the
card (no jax there, so the repository's conftest is bypassed):

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Tolerances: spinner, seeded spinner and srf_decode f32 max|kernel -
plain| <= 1e-4 * max|plain|, bf16 2e-2; the paged gathers bit for bit
(torch.equal), and the f32 seeded spinner bit for bit against the
materialized spinner kernel on the params regenerated on the card.
This file imports torch and the port only.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_gather as kpg
from repro_torch.kernels import spinner as kspin
from repro_torch.kernels import srf_decode as kdec


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


@pytest.mark.cuda
def test_paged_gathers_bit_equal_on_card(cuda_device):
    """paged_gather (bf16, f32, int8 pools) and paged_gather_dequant
    (int8 -> bf16, f32) against their plain versions, bit for bit: an
    aligned shape, ragged row widths and ids out of range."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for n, p, d, r, m in ((33, 16, 64, 4, 8), (7, 3, 13, 3, 5),
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
        q = torch.randint(-127, 128, (n, p, d), generator=gen,
                          device=cuda_device, dtype=torch.int8)
        sc = torch.rand((n, p, 1), generator=gen, device=cuda_device)
        for out in (torch.bfloat16, torch.float32):
            got = ops.paged_gather_dequant(q, sc, tables.int(), out)
            want = ref.paged_gather_dequant_ref(q, sc, tables, out)
            assert got.dtype == out and torch.equal(got, want)


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

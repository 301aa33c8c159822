"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips. On the
card (no jax there, so the repository's conftest is bypassed):

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Tolerances: f32 max|kernel - plain| <= 1e-4 * max|plain|, bf16 2e-2.
This file imports torch and the port only.
"""
import pytest
import torch

from repro_torch.kernels import ref
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

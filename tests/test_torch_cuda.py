"""The port's CUDA kernels on the card, each against its plain PyTorch
version. No JAX here: the machine with the card has none. Every test is
marked ``cuda`` and skips without a GPU; run them there with

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402

BF16_TOL = dict(rtol=2e-2, atol=2e-2)     # tests/test_kernels.py's bf16 bound


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,r", [(64, 2), (128, 1), (128, 4), (256, 2)])
def test_paged_decode_kernel_matches_plain(cuda_device, d, r):
    """K1 against its plain version, bf16 at 2e-2, with a padded slot, a
    kv_len that is not a page multiple, a sequence with no valid row, and
    one counted launch."""
    gen = torch.Generator(device="cpu").manual_seed(d + r)
    b, g, page, p, w = 4, 4, 16, 64, 8
    q = torch.randn((b, g, r, d), generator=gen)
    k = torch.randn((p, page, g, d), generator=gen)
    v = torch.randn((p, page, g, d), generator=gen)
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    phys = torch.randint(1, p, (b, w), generator=gen, dtype=torch.int32)
    logical = torch.arange(w, dtype=torch.int32).repeat(b, 1)
    phys[2, 5:] = -1
    logical[2, 5:] = -1
    logical[3] = -1
    kv_len = torch.tensor([w * page, w * page - 5, 5 * page - 9, 7],
                          dtype=torch.int32)
    args = [t.to(cuda_device) for t in (phys, logical, kv_len)]
    kernels.reset_launches()
    got = kpaged.paged_decode_attention(q, k, v, *args, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode"] == 1
    want = kpaged.paged_decode_reference(q, k, v, *args, scale=d ** -0.5)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16_TOL)
    assert float(got[3].float().abs().max()) == 0.0


@pytest.mark.cuda
def test_paged_decode_kernel_rejects_cpu_fallback(cuda_device):
    """On a CUDA tensor the wrapper launches or raises: a float32 query
    is refused, never served by the plain version."""
    q = torch.zeros((1, 2, 1, 64), device=cuda_device)
    k = torch.zeros((4, 16, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    ints = torch.zeros((1, 2), device=cuda_device, dtype=torch.int32)
    with pytest.raises(TypeError):
        kpaged.paged_decode_attention(q, k, k, ints, ints,
                                      ints[:, 0].contiguous(), scale=0.125)

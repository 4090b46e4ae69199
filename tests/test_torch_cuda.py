"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import copy

import pytest
import torch

from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.ops.cuda.attention import (flash_attention,
                                                flash_attention_plain)
from tlxcv_tpu_torch.ops.cuda.matmul import (int8_matmul, int8_matmul_nt,
                                             int8_matmul_plain)
from tlxcv_tpu_torch.ops.quant import quantize_for_serving

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain runs in f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# f32: the same arithmetic in another summation order.  bf16: against the
# plain version in f32 on the same bf16 inputs; P and the output are
# rounded to bf16.
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,d,bias", [
    (24, 197, 64, None), (8, 577, 64, None), (16, 49, 32, "per_bh"),
    (16, 60, 32, "shared"), (4, 130, 96, None), (4, 256, 128, "shared"),
])
def test_kernel_matches_plain(cuda, dtype, bh, s, d, bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    b = None
    if bias is not None:
        b = torch.randn(bh if bias == "per_bh" else 1, s, s, generator=g,
                        device=cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias=b)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = flash_attention_plain(q.float(), k.float(), v.float(), b)
    torch.testing.assert_close(out.float(), ref, atol=_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d", [(4, 12, 197, 64), (2, 3, 70, 32),
                                     (1, 8, 65, 96)])
def test_kernel_reads_packed_qkv_in_place(cuda, dtype, b, h, s, d):
    """[B, H, S, D] views into a packed [B, S, 3, H, D] projection; the
    output comes back as [B, H, S, D] stored token-major."""
    g = torch.Generator(device=cuda).manual_seed(2)
    packed = torch.randn(b, s, 3, h, d, generator=g, device=cuda).to(dtype)
    q, k, v = packed.permute(2, 0, 3, 1, 4)
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == (b, h, s, d) and out.transpose(1, 2).is_contiguous()
    ref = flash_attention_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), ref, atol=_TOL[dtype], rtol=0)
    strided = flash_attention(q.reshape(b * h, s, d),  # a 3D copy
                              k.reshape(b * h, s, d), v.reshape(b * h, s, d))
    torch.testing.assert_close(strided.reshape(b, h, s, d), out, atol=0,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_rows_match_plain(cuda, dtype):
    s = 128
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, s, 32, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    seg = torch.arange(s, device=cuda) // 64
    bias = torch.where(seg[:, None] == seg[None, :], 0.0, float("-inf"))
    bias[0] = float("-inf")  # row 0 masked across all of S
    bias = bias[None].contiguous()
    out = flash_attention(q, k, v, bias=bias)
    assert torch.isfinite(out).all()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), bias)
    torch.testing.assert_close(out.float(), ref, atol=_TOL[dtype], rtol=0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 16, 48, device=cuda)
    with pytest.raises(ValueError):  # head dim
        flash_attention(q, q, q)
    q = torch.zeros(2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):  # dtype
        flash_attention(q, q, q)
    q = torch.zeros(2, 64, 16, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):  # head dim not contiguous
        flash_attention(q, q, q)
    q = torch.zeros(2, 16, 68, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        flash_attention(q, q, q)


def test_vit_forward_launches_the_kernel_once_per_block(cuda):
    model = create_model("vit_base_patch16_224", depth=3, num_classes=10,
                         generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 224, 224, 3, device=cuda)
    before = flash_attention.launches
    with torch.inference_mode():
        out = model(x)
    assert flash_attention.launches == before + 3
    assert out.shape == (2, 10) and torch.isfinite(out).all()


# ------------------------------------------------------------ int8 GEMM
@pytest.mark.parametrize("m,k,n", [
    (1, 16, 1), (17, 32, 17), (33, 48, 33), (130, 144, 70), (257, 160, 64),
    (1000, 2048, 1000), (300, 4096, 129), (4096, 576, 64),
])
def test_int8_kernel_matches_plain_exactly(cuda, m, k, n):
    """Ragged M and N on both tile widths (N <= 64 and N > 64), K a
    multiple of 16 with and without a partial 64-byte slice."""
    g = torch.Generator(device=cuda).manual_seed(m * n + k)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                      dtype=torch.int8)
    before = int8_matmul.launches
    got = int8_matmul_nt(a, w)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, int8_matmul_plain(a, w.t()))


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (17, 33, 17), (33, 147, 65)])
def test_int8_matmul_pads_k_exactly(cuda, m, k, n):
    """The public [M, K] @ [K, N] contract at any K, and the extremes."""
    g = torch.Generator(device=cuda).manual_seed(k)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    assert torch.equal(int8_matmul(a, b), int8_matmul_plain(a, b))
    full = torch.full((m, k), -127, dtype=torch.int8, device=cuda)
    assert torch.equal(int8_matmul(full, full.t().contiguous()),
                       torch.full((m, m), k * 127 ** 2, dtype=torch.int32,
                                  device=cuda))


def test_int8_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros(8, 24, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):  # K not a multiple of 16
        int8_matmul_nt(a, a)
    a = torch.zeros(8, 48, dtype=torch.int8, device=cuda)[:, :32]
    with pytest.raises(ValueError):  # not contiguous
        int8_matmul_nt(a, torch.zeros(4, 32, dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError):  # two devices
        int8_matmul_nt(torch.zeros(8, 32, dtype=torch.int8, device=cuda),
                       torch.zeros(4, 32, dtype=torch.int8))


def _int8_resnet18():
    """resnet18 quantized for serving on the CPU in f32, as a user would,
    and a copy moved to the card."""
    gen = torch.Generator().manual_seed(0)
    model = create_model("resnet18", num_classes=10, device="cpu",
                         generator=gen).eval()
    calib = torch.randn(2, 64, 64, 3, generator=gen)
    assert quantize_for_serving(model, [calib]) == (20, 21, 21, 8)
    return model, copy.deepcopy(model).cuda()


def test_int8_resnet_launches_the_kernel_per_layer_and_matches_cpu(cuda):
    """21 launches per forward (20 convs and the fc).  Up to the global
    pool every op is an exact int32 product or an IEEE elementwise op, so
    the card agrees with the CPU bitwise there; the pool's f32 mean is
    summed in another order, which can move an fc input code by one.
    Each such code moves a logit by at most a_scale * 127 * max w_scale;
    the bound allows four."""
    cpu, card = _int8_resnet18()
    x = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    before = int8_matmul.launches
    with torch.inference_mode():
        got = card(x.to(cuda))
        torch.cuda.synchronize()
        assert int8_matmul.launches == before + 21
        want = cpu(x)
        torch.testing.assert_close(card.features(x.to(cuda))[-1].cpu(),
                                   cpu.features(x)[-1], rtol=0, atol=0)
        got16 = card(x.to(cuda, torch.bfloat16))
    step = float(cpu.fc.a_scale * 127 * cpu.fc.w_scale.max())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=4 * step)
    assert got16.dtype == torch.bfloat16 and torch.isfinite(got16).all()


def test_int8_maxpool_on_the_card_matches_cpu(cuda):
    """int8 codes pool through shifted slices, padded with -128."""
    from tlxcv_tpu_torch.nn import MaxPool2d

    g = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, (2, 9, 9, 16), generator=g,
                      dtype=torch.int8)
    pool = MaxPool2d(3, 2, 1)
    assert torch.equal(pool(x.to(cuda)).cpu(), pool(x))

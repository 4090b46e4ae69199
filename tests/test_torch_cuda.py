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


# ------------------------------------------------------------ row gather
def _table(n, c, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(n, c, generator=g, device=device).to(dtype)
    return torch.randint(0, 120, (n, c), generator=g, device=device,
                         dtype=torch.int32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
@pytest.mark.parametrize("n,c,r", [
    (500, 256, 777),       # a ragged R
    (2000, 1024, 4097),    # the packed RoIAlign row width
    (37, 3, 5),            # rows of 3 elements: not 16-byte multiples
    (64, 13, 100),
])
def test_gather_kernel_matches_plain_bitwise(cuda, dtype, n, c, r):
    """Repeated indices and rows 0 and N-1 included; every dtype and row
    width, so every copy width (16 down to 1 byte) runs."""
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows, gather_rows_plain

    table = _table(n, c, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(r)
    idx = torch.randint(0, n, (r,), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[:4] = torch.tensor([0, n - 1, 0, n - 1], device=cuda)
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(table, idx))


def test_gather_kernel_misaligned_rows_and_64_bit_offsets(cuda):
    """A table view one row in (its base no longer 16-byte aligned), and a
    2.3 GB table whose last rows lie past byte offset 2^31."""
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows, gather_rows_plain

    base = _table(101, 6, torch.bfloat16, cuda)
    idx = torch.tensor([0, 99, 5, 5, 50], device=cuda, dtype=torch.int32)
    assert torch.equal(gather_rows(base[1:], idx),
                       gather_rows_plain(base[1:], idx))
    n, c = 140_000, 16_384
    big = torch.zeros(n, c, dtype=torch.uint8, device=cuda)
    big[-3:] = torch.arange(3, device=cuda, dtype=torch.uint8)[:, None] + 7
    idx = torch.tensor([n - 1, 0, n - 2, n - 3], device=cuda,
                       dtype=torch.int32)
    got = gather_rows(big, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_plain(big, idx))
    assert int(got[0, 0]) == 9 and int(got[3, -1]) == 7


def test_gather_kernel_rejects_what_it_does_not_take(cuda):
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows

    table = torch.zeros(10, 8, device=cuda)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # not contiguous
        gather_rows(table[:, ::2], idx)
    with pytest.raises(ValueError):  # two devices
        gather_rows(table, idx.cpu())
    with pytest.raises(ValueError):  # int64 indices
        gather_rows(table, idx.long())


# ------------------------------------------------------- upsample + add
# Nearest copies and adds once: bitwise.  Bilinear runs the plain version's
# f32 operations in its order with IEEE multiply and add (no FMA): bitwise
# expected; the stated bounds are 1e-5 (f32, the reference test's) and one
# bf16 step of the largest output (bf16).
def _up_inputs(xshape, out_hw, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(*xshape, generator=g, device=device).to(dtype)
    skip = torch.randn(xshape[0], *out_hw, xshape[3], generator=g,
                       device=device).to(dtype)
    return x, skip


def _check_upsample(got, want, mode):
    assert got.dtype == want.dtype and got.shape == want.shape
    if mode == "nearest":
        assert torch.equal(got, want)
        return
    atol = 1e-5 if got.dtype == torch.float32 else \
        2.0 ** -8 * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("xshape,out_hw", [
    ((2, 20, 20, 256), (40, 40)),    # the FPN's P5 -> P4 step
    ((2, 80, 80, 256), (160, 160)),  # P3 -> P2
    ((1, 38, 38, 8), (75, 75)),      # non-2x, C = 8
    ((2, 7, 9, 16), (7, 18)),        # one axis unchanged
    ((1, 5, 6, 3), (11, 13)),        # C = 3: one channel per thread
])
def test_upsample_kernel_matches_plain(cuda, dtype, mode, xshape, out_hw):
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample_add_fused,
                                                   upsample_add_plain)

    x, skip = _up_inputs(xshape, out_hw, dtype, cuda)
    before = upsample_add_fused.launches
    got = upsample_add_fused(x, skip, mode)
    torch.cuda.synchronize()
    assert upsample_add_fused.launches == before + 1
    _check_upsample(got, upsample_add_plain(x, skip, mode), mode)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_upsample_kernel_takes_strided_views(cuda, mode):
    """NHWC views of NCHW tensors (channels not contiguous) and a cropped
    skip: the kernel reads through the strides."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample_add_fused,
                                                   upsample_add_plain)

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 16, 10, 12, generator=g, device=cuda).permute(
        0, 2, 3, 1)
    skip = torch.randn(2, 24, 30, 16, generator=g, device=cuda)[:, 2:22, :24]
    _check_upsample(upsample_add_fused(x, skip, mode),
                    upsample_add_plain(x, skip, mode), mode)


def test_upsample_kernel_rejects_what_it_does_not_take(cuda):
    from tlxcv_tpu_torch.ops.cuda.upsample import upsample_add_fused

    x = torch.zeros(1, 4, 4, 8, device=cuda)
    with pytest.raises(ValueError):  # two devices
        upsample_add_fused(x, torch.zeros(1, 8, 8, 8))
    with pytest.raises(ValueError):  # f16
        upsample_add_fused(x.half(), torch.zeros(1, 8, 8, 8, device=cuda,
                                                 dtype=torch.float16))


def test_mask_rcnn_forward_launches_both_kernels(cuda):
    """A micro Mask R-CNN on the card: 3 upsample-add launches (the FPN)
    and 2 gathers (box and mask RoIAlign) per forward, in f32 and bf16."""
    from tlxcv_tpu_torch.models.classification import resnet18
    from tlxcv_tpu_torch.models.detection import MaskRCNN
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows
    from tlxcv_tpu_torch.ops.cuda.upsample import upsample_add_fused

    gen = torch.Generator().manual_seed(0)
    model = MaskRCNN(num_classes=4, num_proposals=16, pre_nms_top_k=64,
                     detections_per_image=8, box_score_thresh=0.0,
                     backbone=resnet18(num_classes=0, with_pool=False,
                                       generator=gen),
                     generator=gen).eval()
    x = torch.randn(2, 128, 128, 3, generator=gen).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16:
            for p in model.parameters():
                p.data = p.data.to(dtype)
        g0, u0 = gather_rows.launches, upsample_add_fused.launches
        with torch.inference_mode():
            dets, counts, masks = model(x.to(dtype))
        torch.cuda.synchronize()
        assert gather_rows.launches == g0 + 2
        assert upsample_add_fused.launches == u0 + 3
        assert dets.shape == (2, 8, 6) and masks.shape == (2, 8, 28, 28)
        assert torch.isfinite(dets).all() and torch.isfinite(masks).all()
        assert (counts > 0).all()


# ------------------------------------------------------------- gradients
def test_card_kernels_carry_gradients(cuda):
    """Through the upsample-add and the row gather on the card, a tensor
    that requires grad gets a ``grad_fn``, and its gradient equals the one
    the plain versions give on the CPU: bitwise for the upsample-add (the
    transposed resize kernel takes the plain version's taps in its order),
    within 1e-5 for the gather (its scatter-add adds a repeated row's
    gradients with atomics, in an order that changes from run to run: 50
    N(0, 1) rows into one sum near 8 give a few f32 steps, 3.3e-6 seen)."""
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows
    from tlxcv_tpu_torch.ops.image import upsample_add

    g = torch.Generator().manual_seed(5)
    for mode in ("nearest", "bilinear"):
        x = torch.randn(2, 10, 12, 16, generator=g)
        skip = torch.randn(2, 20, 24, 16, generator=g)
        gy = torch.randn(2, 20, 24, 16, generator=g)
        grads = {}
        for dev in ("cpu", cuda):
            xs = [t.detach().to(dev).requires_grad_() for t in (x, skip)]
            out = upsample_add(*xs, mode=mode)
            assert out.grad_fn is not None
            out.backward(gy.to(dev))
            grads[str(dev)] = [t.grad.cpu() for t in xs]
        for a, b in zip(grads["cpu"], grads["cuda"]):
            assert torch.equal(a, b)
    table = torch.randn(300, 64, generator=g)
    idx = torch.randint(0, 300, (2000,), generator=g, dtype=torch.int32)
    idx[:50] = 3
    gy = torch.randn(2000, 64, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        t = table.detach().to(dev).requires_grad_()
        out = gather_rows(t, idx.to(dev))
        assert out.grad_fn is not None
        out.backward(gy.to(dev))
        grads.append(t.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], atol=1e-5, rtol=0)


_SEP_CASES = [  # (g shape, input hw of the forward, mode)
    ((2, 40, 40, 256), (20, 20), "nearest"),     # the FPN backward, b2
    ((2, 160, 160, 256), (80, 80), "nearest"),
    ((2, 40, 40, 256), (20, 20), "bilinear"),
    ((1, 75, 75, 3), (38, 38), "bilinear"),      # ragged taps, C = 3
    ((1, 75, 75, 8), (38, 38), "nearest"),
    ((1, 75, 75, 256), (38, 38), "bilinear"),
    ((1, 11, 13, 5), (5, 6), "bilinear"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gshape,in_hw,mode", _SEP_CASES)
def test_sep_resize_kernel_matches_plain(cuda, dtype, gshape, in_hw, mode):
    """The transposed resize (the upsample-add's backward) against its
    plain version on the card: the same taps in the same order, IEEE
    multiply and add, one rounding: bitwise."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (sep_resize,
                                                   sep_resize_plain, sep_taps)

    gen = torch.Generator(device=cuda).manual_seed(6)
    gy = torch.randn(*gshape, generator=gen, device=cuda).to(dtype)
    th = sep_taps(gshape[1], in_hw[0], mode, True, cuda)
    tw = sep_taps(gshape[2], in_hw[1], mode, True, cuda)
    before = sep_resize.launches
    got = sep_resize(gy, th, tw)
    torch.cuda.synchronize()
    assert sep_resize.launches == before + 1
    assert got.shape == (gshape[0], *in_hw, gshape[3]) and got.dtype == dtype
    assert torch.equal(got, sep_resize_plain(gy, th, tw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sep_resize_kernel_takes_stride0_and_permuted(cuda, dtype):
    """The gradient of a ``.sum()`` is a stride-0 expand; a permuted one is
    not contiguous; an odd channel offset forbids the vector path.  All
    bitwise equal to the contiguous call and to the plain version."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (sep_resize,
                                                   sep_resize_plain, sep_taps)

    th = sep_taps(40, 20, "bilinear", True, cuda)
    tw = sep_taps(48, 24, "bilinear", True, cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    views = [
        torch.tensor(0.75, device=cuda).to(dtype).expand(2, 40, 48, 64),
        torch.randn(2, 64, 48, 40, generator=gen, device=cuda).to(
            dtype).permute(0, 3, 2, 1),
        torch.randn(2, 40, 48, 65, generator=gen, device=cuda).to(
            dtype)[..., 1:],
    ]
    for v in views:
        got = sep_resize(v, th, tw)
        assert torch.equal(got, sep_resize(v.contiguous(), th, tw))
        assert torch.equal(got, sep_resize_plain(v, th, tw))


def test_upsample2x_on_the_card_matches_the_cpu(cuda):
    """``upsample2x_fused`` forward and backward on the card, through the
    transposed-resize kernel both ways, bitwise against the CPU."""
    from tlxcv_tpu_torch.ops.cuda.upsample import upsample2x_fused

    x = torch.randn(2, 8, 8, 128, generator=torch.Generator().manual_seed(8))
    outs = []
    for dev in ("cpu", cuda):
        t = x.detach().to(dev).requires_grad_()
        y = upsample2x_fused(t)
        (y ** 2).sum().backward()
        outs.append((y.detach().cpu(), t.grad.cpu()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_mask_rcnn_training_step_launches_all_three_kernels(cuda):
    """A micro Mask R-CNN training step on the card: 3 forward
    upsample-adds, 3 transposed resizes in the backward, 2 gathers; every
    parameter that gets a non-zero gradient on the CPU gets one on the
    card (values: ``chip_smoke.py``'s train_check)."""
    from tlxcv_tpu_torch.models.classification import resnet18
    from tlxcv_tpu_torch.models.detection import MaskRCNN
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows
    from tlxcv_tpu_torch.ops.cuda.upsample import (sep_resize,
                                                   upsample_add_fused)

    gen = torch.Generator().manual_seed(0)
    cpu = MaskRCNN(num_classes=4, num_proposals=16, pre_nms_top_k=64,
                   detections_per_image=8, device="cpu",
                   backbone=resnet18(num_classes=0, with_pool=False,
                                     device="cpu", generator=gen),
                   generator=gen).train()
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(2, 128, 128, 3, generator=gen)
    masks = torch.zeros(2, 2, 128, 128)
    masks[0, 0, 10:70, 10:60] = 1
    masks[1, 1, 50:110, 40:100] = 1
    y = {"boxes": torch.tensor([[[10.0, 10, 60, 70], [0, 0, 0, 0]],
                                [[0.0, 0, 0, 0], [40, 50, 100, 110]]]),
         "class_labels": torch.tensor([[1, 0], [0, 2]]),
         "mask": torch.tensor([[1.0, 0], [0, 1]]), "masks": masks}
    cpu.loss_fn(cpu(x), y).backward()
    counts = [f.launches for f in (upsample_add_fused, sep_resize,
                                   gather_rows)]
    card.loss_fn(card(x.to(cuda)),
                 {k: v.to(cuda) for k, v in y.items()}).backward()
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(
        (upsample_add_fused, sep_resize, gather_rows), counts)] == [3, 3, 2]
    for (k, p), q in zip(cpu.named_parameters(), card.parameters()):
        if p.grad is None or not p.grad.any():
            continue
        assert q.grad is not None and q.grad.any(), k

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
from tlxcv_tpu_torch.ops.cuda.matmul import (bf16_matmul, bf16_matmul_plain,
                                             int8_matmul, int8_matmul_nt,
                                             int8_matmul_plain,
                                             int8_matmul_requant,
                                             int8_matmul_requant_plain)
from tlxcv_tpu_torch.ops.quant import (calibrate_activations,
                                       quantize_for_serving, quantize_weights)

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


_S_EDGES = (1, 63, 64, 65, 128, 129, 197, 577)  # about the 64/128-row tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("s", _S_EDGES)
def test_kernel_matches_plain_at_ragged_s(cuda, dtype, d, s):
    """Every head dim at S about the tile edges: no bias, per-BH bias and
    shared bias, [BH, S, D] and packed [B, H, S, D] views."""
    g = torch.Generator(device=cuda).manual_seed(s * d)
    b, h = 2, 3
    packed = torch.randn(b, s, 3, h, d, generator=g, device=cuda).to(dtype)
    q, k, v = packed.permute(2, 0, 3, 1, 4)
    flat = [t.reshape(b * h, s, d).contiguous() for t in (q, k, v)]
    per_bh = torch.randn(b * h, s, s, generator=g, device=cuda)
    for args, bias in ((flat, None), (flat, per_bh), (flat, per_bh[:1]),
                       ((q, k, v), None), ((q, k, v), per_bh)):
        out = flash_attention(*args, bias=bias)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == args[0].shape
        ref = flash_attention_plain(*(t.float() for t in args), bias)
        torch.testing.assert_close(out.float(), ref, atol=_TOL[dtype],
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_fully_masked_row_averages_v(cuda, dtype, d):
    """A row masked across all of S: every real key gets the clamped bias,
    so P is uniform over the S keys and the row is mean(v) (the pinned
    divergence, tests/test_torch_attention.py), at S past one k/v tile."""
    s = 130
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(4, s, d, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    bias = torch.zeros(1, s, s, device=cuda)
    bias[0, 5] = float("-inf")
    out = flash_attention(q, k, v, bias=bias)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[:, 5].float(), v.float().mean(1),
                               atol=_TOL[dtype], rtol=0)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), bias)
    torch.testing.assert_close(out.float(), ref, atol=_TOL[dtype], rtol=0)


def test_backward_through_the_card_matches_the_cpu(cuda):
    """A loss that needs the patch embedding's gradient, through a micro
    ViT's attention on the card (head dim 32, the kernel's smallest): the
    backward runs the flash backward kernel (two launches for the two
    blocks) and every gradient matches the same model's on the CPU within
    1e-4 of its largest magnitude (f32, TF32 off; other summation
    orders)."""
    from tlxcv_tpu_torch.ops.cuda.attention import flash_attention_backward

    def build(device):
        return create_model("vit_base_patch16_224", img_size=32,
                            patch_size=8, embed_dim=128, depth=2,
                            num_heads=4, qkv_bias=True, num_classes=10,
                            device=device,
                            generator=torch.Generator().manual_seed(0))

    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    grads = []
    for dev in ("cpu", cuda):
        model = build(dev)
        loss = torch.logsumexp(model(x.to(dev)), -1).mean()
        before = flash_attention_backward.launches
        loss.backward()
        if dev == cuda:
            assert flash_attention_backward.launches - before == 2
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    for k, want in grads[0].items():
        torch.testing.assert_close(grads[1][k], want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


_BWD_CASES = [  # (bh or (B, H), Sq, Sk, D, bias)
    (8, 197, 197, 64, None), (8, 65, 130, 32, "per_bh"),
    (4, 100, 1050, 32, None), (4, 129, 63, 96, "shared"),
    (4, 77, 77, 128, "row_masked"), ((2, 3), 33, 40, 64, None)]
# the edges of the kernel's 64-row tiles at every head dim: Sq and Sk each
# in _BWD_SIZES against both neighbours there, [B, H, S, D] tensors (the
# output's gradient token-major), the biases in turn; and ViT's packed qkv
# views
_BWD_SIZES = (1, 63, 64, 65, 127, 128, 129, 197)
_BWD_BIASES = (None, "shared", "per_bh", "row_masked")
_BWD_CASES += [
    ((2, 3), sq, _BWD_SIZES[(i + step) % 8], d,
     _BWD_BIASES[(2 * i + (step > 0) + d // 32) % 4])
    for d in (32, 64, 96, 128) for i, sq in enumerate(_BWD_SIZES)
    for step in (1, -1)]
_BWD_CASES += [("packed", s, s, d, _BWD_BIASES[(s + d) % 4])
               for d in (32, 64, 96, 128) for s in (1, 65, 128, 197)]


def _bwd_inputs(lead, sq, sk, d, dtype, gen, cuda):
    """q, k, v: [*lead, S, D] tensors, or with ``lead == "packed"`` the
    [2, 3, S, D] views into one packed [2, S, 3, 3, D] projection that a
    ViT block hands the kernel."""
    if lead == "packed":
        packed = torch.randn(2, sq, 3, 3, d, generator=gen, device=cuda)
        return list(packed.to(dtype).permute(2, 0, 3, 1, 4))
    lead = lead if isinstance(lead, tuple) else (lead,)
    return [torch.randn(*lead, n, d, generator=gen, device=cuda).to(dtype)
            for n in (sq, sk, sk)]


def _bwd_scales(want, sk):
    """The largest magnitude of dq, dk and dv, the scale of each bound; at
    Sk = 1 dv's for all three: there dq and dk are 0 in exact arithmetic
    (a softmax over one key is constant, so dP - delta cancels) and both
    sides give rounding of that cancellation."""
    scales = [float(w.float().abs().max()) for w in want]
    return [scales[2]] * 3 if sk == 1 else scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,bias_kind", _BWD_CASES)
def test_backward_kernel_matches_plain(cuda, dtype, bh, sq, sk, d,
                                       bias_kind):
    """dq, dk and dv from the backward kernel against
    ``flash_attention_backward_plain`` on the kernel's output and
    log-sum-exp, within the forward's bounds of each gradient's largest
    magnitude (``_bwd_scales``), bitwise equal over two runs (no
    atomics); the log-sum-exp
    the forward writes within 1e-4 of the plain one's (rows not masked at
    every key); in f32 also within 1e-4 of SDPA's gradients (without a
    row masked at every key, where SDPA gives NaN)."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q, k, v = _bwd_inputs(bh, sq, sk, d, dtype, gen, cuda)
    n = q.shape[:-2].numel()
    bias = None
    if bias_kind is not None:
        bias = torch.randn(n if bias_kind != "shared" else 1, sq, sk,
                           generator=gen, device=cuda)
        if bias_kind == "row_masked":
            bias[:, 0] = float("-inf")
            bias[:, 1:, 1::3] = float("-inf")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = A.flash_attention(*leaves, bias=bias)
    dout = torch.randn(out.shape, generator=gen, device=cuda).to(dtype)
    got = torch.autograd.grad(out, leaves, dout)
    again = torch.autograd.grad(A.flash_attention(*leaves, bias=bias),
                                leaves, dout)
    _, lse = A._launch_kernel(q, k, v, bias, d ** -0.5, with_lse=True)
    want = A.flash_attention_backward_plain(q, k, v, bias, None,
                                            out.detach(), lse, dout)
    for a, b, w, scale in zip(got, again, want, _bwd_scales(want, sk)):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=_TOL[dtype] * scale)
    _, plain_lse = A.flash_attention_plain(q, k, v, bias, return_lse=True)
    rows = plain_lse > A.NEG
    torch.testing.assert_close(lse[rows], plain_lse[rows], rtol=0, atol=1e-4)
    if dtype == torch.float32 and bias_kind != "row_masked":
        ref = [t.detach().requires_grad_() for t in (q, k, v)]
        mask = None
        if bias is not None:
            mask = bias.view(*q.shape[:-2], sq, sk) if bias.shape[0] > 1 \
                else bias[0]
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            *ref, attn_mask=mask)
        witness = torch.autograd.grad(sdpa, ref, dout)
        for a, w, scale in zip(got, witness, _bwd_scales(witness, sk)):
            torch.testing.assert_close(a, w, rtol=0, atol=1e-4 * scale)


# The f32 kernels (split TF32 on the tensor cores) stream the other side in
# stages of 32 rows (16 above D = 64) against resident tiles of 64 rows:
# Sq and Sk about both edges, each against a neighbour three along, the
# biases in turn, then ViT's and TrOCR's packed qkv views
_F32_SIZES = (1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 129)
_F32_BIASES = (None, "shared", "per_bh", "row_masked", "causal")
_F32_CASES = [
    ((2, 3), sq, _F32_SIZES[(i + 3) % len(_F32_SIZES)], d,
     _F32_BIASES[(i + d // 32) % 5])
    for d in (32, 64, 96, 128) for i, sq in enumerate(_F32_SIZES)]
_F32_CASES += [("packed", s, s, d, _F32_BIASES[(s + d // 32) % 5])
               for d in (32, 64, 96, 128) for s in (17, 64, 577)]


@pytest.mark.parametrize("lead,sq,sk,d,bias_kind", _F32_CASES)
def test_f32_kernels_on_split_tf32(cuda, lead, sq, sk, d, bias_kind):
    """The f32 forward and backward kernels: the output within 1e-4 of the
    plain version's, the rows' log-sum-exp within 1e-4, dq, dk and dv
    within 1e-4 of each one's largest magnitude (``_bwd_scales``); two runs
    bitwise equal, and bitwise the same with
    ``torch.backends.cuda.matmul.allow_tf32`` on (the kernels never read
    it); one backward call a gradient."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    gen = torch.Generator(device=cuda).manual_seed(7 * sq + sk + d)
    q, k, v = _bwd_inputs(lead, sq, sk, d, torch.float32, gen, cuda)
    n = q.shape[:-2].numel()
    bias = None
    if bias_kind == "causal":
        bias = torch.triu(torch.full((1, sq, sk), -1e9, device=cuda), 1)
    elif bias_kind is not None:
        bias = torch.randn(n if bias_kind != "shared" else 1, sq, sk,
                           generator=gen, device=cuda)
        if bias_kind == "row_masked":
            bias[:, 0] = float("-inf")
            bias[:, 1:, 1::3] = float("-inf")
    dout = torch.randn(*q.shape[:-2], sq, d, generator=gen, device=cuda)

    def run():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = A.flash_attention(*leaves, bias=bias)
        return (out.detach(), *torch.autograd.grad(out, leaves, dout))

    before = A.flash_attention_backward.launches
    first, second = run(), run()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        flagged = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    assert A.flash_attention_backward.launches - before == 3
    for a, b, c in zip(first, second, flagged):
        assert torch.equal(a, b) and torch.equal(a, c)
    out, grads = first[0], first[1:]
    want_out, want_lse = A.flash_attention_plain(q, k, v, bias,
                                                 return_lse=True)
    torch.testing.assert_close(out, want_out, rtol=0, atol=1e-4)
    _, lse = A._launch_kernel(q, k, v, bias, d ** -0.5, with_lse=True)
    rows = want_lse > A.NEG
    torch.testing.assert_close(lse[rows], want_lse[rows], rtol=0, atol=1e-4)
    want = A.flash_attention_backward_plain(q, k, v, bias, None, out, lse,
                                            dout)
    # a causal mask over one query row leaves it one key: as at Sk = 1,
    # dq and dk are 0 in exact arithmetic (``_bwd_scales``)
    seen = 1 if bias_kind == "causal" and sq == 1 else sk
    for a, w, scale in zip(grads, want, _bwd_scales(want, seen)):
        assert a.dtype == torch.float32 and a.shape == w.shape
        torch.testing.assert_close(a, w, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_run_on_autograds_thread(cuda, dtype):
    """The forward recomputed under ``torch.utils.checkpoint`` and the
    backward both run on autograd's own thread, where PyTorch may have
    made no context current: the bf16 kernels' tensor maps must still be
    encoded there.  The gradients equal those without the recompute,
    bitwise."""
    from torch.utils.checkpoint import checkpoint

    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(2, 3, 77, 64, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    dout = torch.randn(2, 3, 77, 64, generator=g, device=cuda).to(dtype)
    grads = []
    for remat in (False, True):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = (checkpoint(flash_attention, *leaves, use_reentrant=False)
               if remat else flash_attention(*leaves))
        grads.append(torch.autograd.grad(out, leaves, dout))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 16, 129, device=cuda)
    with pytest.raises(ValueError, match="128"):  # head dim past 128
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
    (1000, 512, 255), (129, 16, 256), (333, 2048, 1000), (4099, 64, 1),
    (65, 4608, 17), (130, 576, 128), (1, 16, 2048),
])
def test_int8_kernel_matches_plain_exactly(cuda, m, k, n):
    """Ragged M and N on every tile width (64, 128, 256), K a multiple of
    16 with and without a partial 128-byte slice; N = 255 in one
    256-column tile (its row stride no multiple of 16 bytes), N over
    several tiles, one K step of 16."""
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


_REQUANT_OUT = [("int8_relu", torch.int8, True), ("int8", torch.int8, False),
                ("bf16", torch.bfloat16, False), ("f32", torch.float32, False)]


@pytest.mark.parametrize("kind,out_dtype,relu", _REQUANT_OUT,
                         ids=[o[0] for o in _REQUANT_OUT])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("n", [1, 17, 64, 255, 256, 1000])
def test_int8_requant_kernel_matches_plain_bitwise(cuda, kind, out_dtype,
                                                   relu, bias, n):
    """The fused epilogue against the plain product and the PyTorch
    epilogue, bitwise, at Kp = 16, 64, 576 and 4608 and a ragged M: one
    launch each, counted on int8_matmul."""
    for i, kp in enumerate((16, 64, 576, 4608)):
        m = (333, 1, 129, 4099)[i]
        g = torch.Generator(device=cuda).manual_seed(n * kp + i)
        a = torch.randint(-127, 128, (m, kp), generator=g, device=cuda,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (n, kp), generator=g, device=cuda,
                          dtype=torch.int8)
        spread = 40 / (127 ** 2 / 3 * kp ** 0.5)  # y of spread ~40
        ep = {"scale": (0.5 + 1.5 * torch.rand(n, generator=g, device=cuda))
              * spread,
              "bias": 10 * torch.randn(n, generator=g, device=cuda)
              if bias else None, "relu": relu,
              "out_scale": torch.tensor(0.37, device=cuda)
              if out_dtype == torch.int8 else None, "out_dtype": out_dtype}
        before = int8_matmul.launches
        got = int8_matmul_requant(a, w, **ep)
        torch.cuda.synchronize()
        assert int8_matmul.launches == before + 1
        want = int8_matmul_requant_plain(a, w, **ep)
        assert got.dtype == want.dtype == out_dtype and got.shape == (m, n)
        assert torch.equal(got, want), (kind, m, kp, n)


def test_int8_requant_kernel_rounds_ties_to_even(cuda):
    """y = acc + 0.5 over out_scale 1: every quotient a tie."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a, w = (torch.randint(-1, 2, s, generator=g, device=cuda,
                          dtype=torch.int8) for s in ((300, 16), (70, 16)))
    for relu in (False, True):
        ep = {"scale": torch.ones(70, device=cuda),
              "bias": torch.full((70,), 0.5, device=cuda), "relu": relu,
              "out_scale": torch.tensor(1.0, device=cuda),
              "out_dtype": torch.int8}
        assert torch.equal(int8_matmul_requant(a, w, **ep),
                           int8_matmul_requant_plain(a, w, **ep))


def test_int8_requant_kernel_refuses_grad_and_bad_inputs(cuda):
    a = torch.zeros(8, 32, dtype=torch.int8, device=cuda)
    w = torch.zeros(4, 32, dtype=torch.int8, device=cuda)
    scale = torch.ones(4, device=cuda)
    bias = torch.nn.Parameter(torch.zeros(4, device=cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        int8_matmul_requant(a, w, scale, bias)
    with pytest.raises(ValueError):  # the scale on another device
        int8_matmul_requant(a, w, scale.cpu())
    with pytest.raises(ValueError):  # K not a multiple of 16
        int8_matmul_requant(a[:, :24], w[:, :24].contiguous(), scale)
    with pytest.raises(ValueError), torch.inference_mode():  # K = 0
        int8_matmul_requant(a[:, :0].contiguous(), w[:, :0].contiguous(),
                            scale)
    with torch.inference_mode():
        assert int8_matmul_requant(a, w, scale, bias).abs().max() == 0


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


def test_int8_resnet_layers_take_the_fused_kernel_bitwise(cuda):
    """Each int8 layer of a micro int8 ResNet, given the CPU's input to it,
    launches the fused kernel once and returns the CPU's output bitwise
    (int8 codes, bf16 or f32): the epilogue runs the CPU's f32 operations
    in its order.  A forward with autograd recording raises, since the
    fused route has no backward."""
    from tlxcv_tpu_torch.nn import Conv2d, Linear

    cpu, card = _int8_resnet18()
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    seen = []
    layers = [m for m in cpu.modules() if isinstance(m, (Conv2d, Linear))
              and m.weight.dtype == torch.int8]
    handles = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0], out)))
        for m in layers]
    with torch.inference_mode():
        cpu(x)
    for h in handles:
        h.remove()
    names = {id(m): p for p, m in cpu.named_modules()}
    card_mods = dict(card.named_modules())
    assert len(seen) == 21
    kinds = set()
    with torch.inference_mode():
        for mod, xin, yout in seen:
            before = int8_matmul.launches
            got = card_mods[names[id(mod)]](xin.to(cuda))
            torch.cuda.synchronize()
            assert int8_matmul.launches == before + 1
            assert got.dtype == yout.dtype
            assert torch.equal(got.cpu(), yout), names[id(mod)]
            kinds.add(yout.dtype)
    assert torch.int8 in kinds and len(kinds) >= 2
    with pytest.raises(RuntimeError, match="no backward"):
        card(x.to(cuda))


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


@pytest.mark.parametrize("dtype,c_bytes", [
    (dtype, c_bytes)
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.uint8)
    for c_bytes in (16, 48, 2048, 16384, 32768, 6, 24)
    if c_bytes % torch.tensor([], dtype=dtype).element_size() == 0])
def test_gather_bulk_and_warp_paths_byte_exact(cuda, dtype, c_bytes):
    """Row widths through both paths of the kernel: 16-byte multiples up to
    a whole 8 KB slot by bulk async copies (32, 32 and 4 rows a chunk, the
    ring wrapping many times), wider rows and rows of 6 or 24 bytes (no
    multiple of 16) by the warp copy; and a
    base one row in, 16-byte aligned or not."""
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows, gather_rows_plain

    c = c_bytes // torch.tensor([], dtype=dtype).element_size()
    n = 3000 if c_bytes <= 2048 else 300
    table = _table(n + 1, c, dtype, cuda, seed=c_bytes)
    g = torch.Generator(device=cuda).manual_seed(c_bytes)
    for r in (1, 31, 33, 5000):
        idx = torch.randint(0, n, (r,), generator=g, device=cuda,
                            dtype=torch.int32)
        for t in (table[:n], table[1:]):
            got = gather_rows(t, idx)
            torch.cuda.synchronize()
            assert torch.equal(got, gather_rows_plain(t, idx)), (r, c_bytes)


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
    """Through the upsample-add, the row gather and flash attention on the
    card, a tensor
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
    # flash attention: q, k and v (DETR's cross-attention shape, a bias)
    # through the forward and backward kernels, against autograd through
    # the plain version on the CPU, within 1e-4 of the largest magnitude
    q = torch.randn(2, 4, 100, 32, generator=g)
    k, v = (torch.randn(2, 4, 150, 32, generator=g) for _ in range(2))
    bias = torch.randn(8, 100, 150, generator=g)
    gy = torch.randn(2, 4, 100, 32, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        xs = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*xs, bias=bias.to(dev))
        assert out.grad_fn is not None
        out.backward(gy.to(dev))
        grads.append([t.grad.cpu() for t in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=0,
                                   atol=1e-4 * float(a.abs().max()))


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
    2x kernels (one launch each; the generic transposed resize is not
    launched), bitwise against the CPU."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (sep_resize,
                                                   upsample2x_fused,
                                                   upsample2x_vjp)

    x = torch.randn(2, 8, 8, 128, generator=torch.Generator().manual_seed(8))
    outs = []
    for dev in ("cpu", cuda):
        t = x.detach().to(dev).requires_grad_()
        before = [f.launches for f in (upsample2x_fused, upsample2x_vjp,
                                       sep_resize)]
        y = upsample2x_fused(t)
        (y ** 2).sum().backward()
        torch.cuda.synchronize()
        moved = [f.launches - b for f, b in zip(
            (upsample2x_fused, upsample2x_vjp, sep_resize), before)]
        assert moved == ([0, 0, 0] if dev == "cpu" else [1, 1, 0])
        outs.append((y.detach().cpu(), t.grad.cpu()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 4, 6, 8, 256])
def test_upsample2x_kernels_match_plain_bitwise(cuda, dtype, c):
    """Both 2x kernels against their plain versions on the card, bitwise,
    at every height and width in {1, 2, 3} (the taps' edges) and at 5 x 7;
    C = 3, 4, 6, 8, 256 take one element a thread, 4 or 8 bytes, and 16
    bytes with one or many threads a pixel (the dense 16-byte inputs take
    the bulk-copy routes)."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample2x_fused,
                                                   upsample2x_plain,
                                                   upsample2x_vjp,
                                                   upsample2x_vjp_plain)

    gen = torch.Generator(device=cuda).manual_seed(16)
    for h, w in [(h, w) for h in (1, 2, 3) for w in (1, 2, 3)] + [(5, 7)]:
        x = torch.randn(2, h, w, c, generator=gen, device=cuda).to(dtype)
        g = torch.randn(2, 2 * h, 2 * w, c, generator=gen, device=cuda).to(
            dtype)
        before = upsample2x_fused.launches, upsample2x_vjp.launches
        y, dx = upsample2x_fused(x), upsample2x_vjp(g)
        torch.cuda.synchronize()
        assert (upsample2x_fused.launches, upsample2x_vjp.launches) == (
            before[0] + 1, before[1] + 1)
        assert y.shape == (2, 2 * h, 2 * w, c) and y.dtype == dtype
        assert torch.equal(y, upsample2x_plain(x)), (h, w)
        assert dx.shape == x.shape and dx.dtype == dtype
        assert torch.equal(dx, upsample2x_vjp_plain(g)), (h, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample2x_kernels_take_strided_views(cuda, dtype):
    """A stride-0 g (the gradient of a ``.sum()``), permuted x and g
    (channels not contiguous) and sliced ones (channels contiguous, rows
    not dense: the pointer routes at 16 bytes) give the contiguous call's
    result and the plain version's, bitwise; the P3 shape in both routes."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample2x_fused,
                                                   upsample2x_plain,
                                                   upsample2x_vjp,
                                                   upsample2x_vjp_plain)

    gen = torch.Generator(device=cuda).manual_seed(17)
    big = torch.randn(8, 80, 80, 256, generator=gen, device=cuda).to(dtype)
    cases = [
        (upsample2x_vjp, upsample2x_vjp_plain,
         torch.tensor(0.75, device=cuda).to(dtype).expand(2, 40, 48, 64)),
        (upsample2x_fused, upsample2x_plain, torch.randn(
            2, 64, 20, 24, generator=gen, device=cuda).to(dtype).permute(
            0, 2, 3, 1)),
        (upsample2x_vjp, upsample2x_vjp_plain, torch.randn(
            2, 64, 40, 48, generator=gen, device=cuda).to(dtype).permute(
            0, 2, 3, 1)),
        (upsample2x_fused, upsample2x_plain, torch.randn(
            2, 20, 24, 128, generator=gen, device=cuda).to(dtype)[..., 32:96]),
        (upsample2x_vjp, upsample2x_vjp_plain, torch.randn(
            2, 40, 48, 128, generator=gen, device=cuda).to(dtype)[..., 32:96]),
        (upsample2x_fused, upsample2x_plain, big),
        (upsample2x_fused, upsample2x_plain, big[:, :, 8:72]),  # not dense
    ]
    for fn, plain, v in cases:
        got = fn(v)
        assert got.is_contiguous()
        assert torch.equal(got, fn(v.contiguous()))
        assert torch.equal(got, plain(v))


def test_upsample2x_carries_gradients(cuda):
    """Through ``upsample2x_fused`` on the card a tensor that requires grad
    gets a ``grad_fn``; the gradient autograd hands the VJP kernel after a
    ``.sum()`` (stride 0) and after ``y * gy`` gives the CPU's, bitwise, in
    f32 and bf16."""
    from tlxcv_tpu_torch.ops.cuda.upsample import upsample2x_fused

    g = torch.Generator().manual_seed(18)
    x = torch.randn(2, 6, 10, 16, generator=g)
    gy = torch.randn(2, 12, 20, 16, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        for loss in (lambda y, w: y.sum(), lambda y, w: (y * w).sum()):
            grads = []
            for dev in ("cpu", cuda):
                t = x.to(dev, dtype).detach().requires_grad_()
                y = upsample2x_fused(t)
                assert y.grad_fn is not None
                loss(y, gy.to(dev, dtype)).backward()
                grads.append(t.grad.cpu())
            assert torch.equal(*grads)


def test_upsample2x_rejects_what_its_kernels_do_not_take(cuda):
    """Not NHWC, not f32 or bf16, a g of odd height or width, a tensor on
    neither the CPU nor a CUDA device: ValueError, no launch."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (_upsample2x_kernel,
                                                   upsample2x_fused,
                                                   upsample2x_vjp)

    before = upsample2x_fused.launches, upsample2x_vjp.launches
    for bad in (torch.zeros(2, 4, 4, device=cuda),
                torch.zeros(1, 2, 2, 8, dtype=torch.float16, device=cuda)):
        for fn in (upsample2x_fused, upsample2x_vjp):
            with pytest.raises(ValueError):
                fn(bad)
    with pytest.raises(ValueError, match="2H, 2W"):
        upsample2x_vjp(torch.zeros(1, 3, 4, 8, device=cuda))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        upsample2x_fused(torch.zeros(1, 2, 2, 8, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):  # the kernel's
        _upsample2x_kernel(torch.zeros(1, 2, 2, 8), vjp=False)  # own check
    assert (upsample2x_fused.launches, upsample2x_vjp.launches) == before


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


# ------------------------------------------------------------ bf16 GEMM
@pytest.mark.parametrize("m,k,n", [
    (1000, 520, 1000), (1, 64, 9), (129, 1001, 77), (257, 4096, 130),
    (1, 4096, 4096), (4096, 4096, 1), (129, 64, 77), (300, 9, 260),
    (64, 512, 513),
])
def test_bf16_kernel_matches_plain(cuda, m, k, n):
    """Ragged M and N, one row, one column, K the wrapper pads to a
    multiple of 8 (from 9 and 1001), N past one 256-wide tile.  Both sum in
    f32 and round once, in other orders: each element within one bf16 ulp
    of the larger result plus the f32 reordering bound 2 (K - 1) 2^-24
    sum_k |a_ik b_kj|; integer operands, whose sums are exact, bitwise."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn(k, n, generator=g, device=cuda).to(torch.bfloat16)
    before = bf16_matmul.launches
    got = bf16_matmul(a, b)
    torch.cuda.synchronize()
    assert bf16_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    want = bf16_matmul_plain(a, b).float()
    big = torch.maximum(got.float().abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    reorder = 2 * (k - 1) * 2.0 ** -24 * (a.float().abs() @ b.float().abs())
    assert bool(((got.float() - want).abs() <= ulp + reorder).all())
    ai, bi = (torch.randint(-4, 5, t.shape, generator=g, device=cuda).to(
        torch.bfloat16) for t in (a, b))
    assert torch.equal(bf16_matmul(ai, bi), bf16_matmul_plain(ai, bi))


def test_bf16_kernel_is_exact_at_4096_cubed(cuda):
    """Integer operands at the probe's 4096^3: every partial sum exact in
    f32 (|sum| <= 4096 * 16), so the kernel and the plain version agree
    bitwise."""
    g = torch.Generator(device=cuda).manual_seed(11)
    a, b = (torch.randint(-4, 5, (4096, 4096), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    assert torch.equal(bf16_matmul(a, b), bf16_matmul_plain(a, b))


def test_bf16_kernel_is_exact_on_exact_sums(cuda):
    """Integer operands: every partial sum is exact in f32, so the kernel
    and the plain version round the same value and agree bitwise."""
    g = torch.Generator(device=cuda).manual_seed(3)
    a, b = (torch.randint(-4, 5, s, generator=g, device=cuda).to(
        torch.bfloat16) for s in ((300, 2048), (2048, 260)))
    assert torch.equal(bf16_matmul(a, b), bf16_matmul_plain(a, b))


def test_bf16_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros(8, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # two devices
        bf16_matmul(a, torch.zeros(16, 4, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        bf16_matmul(a, a.t().float())


def test_int8_yolov3_launches_the_kernel_per_conv(cuda):
    """YOLOv3 quantized as the bench builds it, on the CPU in f32: every
    one of its 75 convolutions launches the int8 GEMM once per forward,
    and bf16 images give finite detections."""
    gen = torch.Generator().manual_seed(0)
    model = create_model("yolov3", device="cpu", generator=gen,
                         num_classes=6, keep_top_k=20).eval()
    calib = torch.randn(2, 64, 64, 3, generator=gen)
    assert quantize_weights(model) == 75
    assert calibrate_activations(model, [calib],
                                 forward=model.head_outputs) == 75
    card = model.cuda()
    x = torch.randn(2, 64, 64, 3, generator=gen).to(cuda, torch.bfloat16)
    before = int8_matmul.launches
    with torch.inference_mode():
        dets, counts = card(x)
        torch.cuda.synchronize()
    assert int8_matmul.launches == before + 75
    assert dets.shape == (2, 20, 6) and torch.isfinite(dets).all()


# ------------------------------------------- int8 attention, grouped int8
def test_int8_attention_products_exact_with_tf32_on(cuda):
    """The int8 attention's two products on the card (the f32 product of
    the codes) equal the CPU's int32 sums bitwise at ViT-B/16's shapes,
    with TF32 switched on globally: the call turns it off for itself and
    restores it.  The whole int8 attention on the card then agrees with
    the CPU's on the same inputs: the softmaxes may differ in the last
    ulp and move a probability code by one."""
    from tlxcv_tpu_torch.nn.attention import (_int8_sdpa, int8_products,
                                              int8_products_plain)

    g = torch.Generator().manual_seed(9)
    q = torch.randint(-127, 128, (4, 12, 197, 64), generator=g,
                      dtype=torch.int8)
    k = torch.randint(-127, 128, (4, 12, 197, 64), generator=g,
                      dtype=torch.int8)
    p = torch.randint(0, 128, (4, 12, 197, 197), generator=g,
                      dtype=torch.int8)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        for a, b in ((q, k.transpose(-1, -2)), (p, k)):
            got = int8_products(a.to(cuda), b.to(cuda))
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.equal(got.cpu().to(torch.int32),
                               int8_products_plain(a, b))
        x = [torch.randn(2, 12, 197, 64, generator=g) for _ in range(3)]
        with torch.inference_mode():
            want = _int8_sdpa(*x, None, 0.125)
            got = _int8_sdpa(*(t.to(cuda) for t in x), None, 0.125).cpu()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max(),
                               rtol=0)


def _grouped_int8_conv(fused, gen):
    from tlxcv_tpu_torch.nn.layers import Conv2d, set_quant_attr

    conv = Conv2d(128, 128, 3, padding=1, groups=32, device="cpu")
    conv.load_int8(torch.randint(-127, 128, (128, 4, 3, 3), generator=gen,
                                 dtype=torch.int8),
                   0.001 + 0.01 * torch.rand(128, generator=gen))
    set_quant_attr(conv, "bias", torch.randn(128, generator=gen))
    set_quant_attr(conv, "a_scale", 0.031)
    if fused:
        set_quant_attr(conv, "out_scale", 0.057)
        conv.relu_fused = True
    return conv


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_int8_conv_on_the_card_is_bitwise(cuda, fused, dtype):
    """ResNeXt's grouped 3x3 (128 -> 128, 32 groups) on the card: one int8
    GEMM launch per group, bitwise equal to the plain route on the CPU on
    the same input, for a float input and for int8 codes with the fused
    requantize."""
    gen = torch.Generator().manual_seed(11)
    conv = _grouped_int8_conv(fused, gen)
    card = copy.deepcopy(conv).to(cuda)
    x = (torch.randint(-127, 128, (2, 14, 14, 128), generator=gen,
                       dtype=torch.int8) if fused
         else torch.randn(2, 14, 14, 128, generator=gen).to(dtype))
    before = int8_matmul.launches
    with torch.inference_mode():
        got = card(x.to(cuda))
        torch.cuda.synchronize()
        want = conv(x)
    assert int8_matmul.launches == before + 32
    assert got.dtype == want.dtype and got.shape == (2, 14, 14, 128)
    assert torch.equal(got.cpu(), want)


def test_serving_only_int8_paths_raise_on_grad(cuda):
    """The int8 convs (grouped and not), the int8 Linear and the int8
    attention have no backward: on the card, an input that requires grad
    raises where autograd would record, rather than hand back no gradient,
    also when every parameter is frozen."""
    from tlxcv_tpu_torch.nn.attention import scaled_dot_product_attention
    from tlxcv_tpu_torch.nn.layers import Conv2d, Linear, set_quant_attr

    gen = torch.Generator().manual_seed(1)
    grouped = _grouped_int8_conv(False, gen)
    plain = Conv2d(128, 16, 3, padding=1, device="cpu", generator=gen)
    linear = Linear(128, 16, device="cpu", generator=gen)
    for layer in (plain, linear):
        layer.load_int8(torch.randint(-127, 128, layer.weight.shape,
                                      generator=gen, dtype=torch.int8),
                        0.001 + 0.01 * torch.rand(16, generator=gen))
        set_quant_attr(layer, "a_scale", 0.031)
    x = torch.randn(1, 6, 6, 128, device=cuda, requires_grad=True)
    for layer in (grouped, plain, linear):
        layer.bias.requires_grad_(False)
        layer = layer.to(cuda)
        with pytest.raises(RuntimeError, match="no backward"):
            layer(x)
        with torch.no_grad():
            assert layer(x).shape[:3] == (1, 6, 6)
    q = torch.randn(1, 2, 16, 32, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="serving-only"):
        scaled_dot_product_attention(q, q, q, use_int8=True)
    with torch.no_grad():
        assert scaled_dot_product_attention(q, q, q, use_int8=True).shape \
            == q.shape


def test_deit_and_swin_on_the_card_match_the_cpu(cuda):
    """DeiT launches the flash kernel once per block (S = 18 here); Swin's
    window attention is plain PyTorch and launches nothing of ours; both
    agree with the CPU in f32 (TF32 off)."""
    from tlxcv_tpu_torch.models.classification import (SwinTransformer,
                                                       deit_base)
    from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul as int8

    gen = torch.Generator().manual_seed(3)
    for build, kw, flash in (
            (deit_base, dict(img_size=32, patch_size=8, embed_dim=128,
                             depth=2, num_heads=4, num_classes=10), 2),
            (SwinTransformer, dict(img_size=56, embed_dim=32, depths=(2, 2),
                                   num_heads=(2, 4), num_classes=10), 0)):
        cpu = build(device="cpu", **kw).eval()
        card = copy.deepcopy(cpu).to(cuda)
        x = torch.randn(2, kw["img_size"], kw["img_size"], 3, generator=gen)
        before = (flash_attention.launches, int8.launches)
        with torch.inference_mode():
            got = card(x.to(cuda)).cpu()
            want = cpu(x)
        assert (flash_attention.launches - before[0],
                int8.launches - before[1]) == (flash, 0)
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max(),
                                   rtol=0)


def test_hrnet_seg_on_the_card_matches_the_cpu(cuda):
    """hrnet_w18_small_v1 under the FCN head at 64 px, unconverted and
    converted to space-to-depth branches: the card in f32 (TF32 off)
    against the CPU, and no kernel of ours launched."""
    from tlxcv_tpu_torch.models.backbones.hrnet import (
        convert_hrnet_branches_to_s2d, hrnet_w18_small_v1)
    from tlxcv_tpu_torch.models.segmentation import FCN

    gen = torch.Generator().manual_seed(4)
    cpu = FCN(5, hrnet_w18_small_v1(device="cpu", generator=gen),
              device="cpu", generator=gen).eval()
    x = torch.randn(2, 64, 64, 3, generator=gen)
    for convert in (False, True):
        if convert:
            assert convert_hrnet_branches_to_s2d(cpu) > 0
        card = copy.deepcopy(cpu).to(cuda)
        before = (flash_attention.launches, int8_matmul.launches)
        with torch.inference_mode():
            got = card(x.to(cuda)).cpu()
            want = cpu(x)
        assert (flash_attention.launches, int8_matmul.launches) == before
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max(),
                                   rtol=0)


# (sq, sk): one query row, keys about the 64-key tiles, DETR-R50's cross
# grid (100 queries over 1050 keys) and fewer keys than queries
_SQ_SK = [(1, 1), (1, 63), (100, 65), (100, 1050), (65, 1), (129, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("sq,sk", _SQ_SK)
def test_kernel_matches_plain_at_its_own_key_length(cuda, dtype, d, sq, sk):
    """Sq != Sk launches the kernel (counted), at every head dim: [BH, S,
    D] tensors with no, per-BH and shared bias, and [B, H, S, D] views into
    token-major projections (q from [B, Sq, H, D], k and v from one packed
    [B, Sk, 2, H, D]), as DETR's cross-attention hands them over."""
    g = torch.Generator(device=cuda).manual_seed(sq * 1000 + sk + d)
    b, h = 2, 3
    q = torch.randn(b, sq, h, d, generator=g, device=cuda).to(dtype)
    kv = torch.randn(b, sk, 2, h, d, generator=g, device=cuda).to(dtype)
    q4 = q.transpose(1, 2)
    k4, v4 = kv.permute(2, 0, 3, 1, 4)
    flat = [t.reshape(b * h, -1, d).contiguous() for t in (q4, k4, v4)]
    per_bh = torch.randn(b * h, sq, sk, generator=g, device=cuda)
    for args, bias in ((flat, None), (flat, per_bh), (flat, per_bh[:1]),
                       ((q4, k4, v4), None), ((q4, k4, v4), per_bh)):
        before = flash_attention.launches
        out = flash_attention(*args, bias=bias)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert out.dtype == dtype and out.shape == args[0].shape
        ref = flash_attention_plain(*(t.float() for t in args), bias)
        torch.testing.assert_close(out.float(), ref, atol=_TOL[dtype],
                                   rtol=0)


def _frozen_bn_statistics_from_data(model, x):
    """Each FrozenBatchNorm takes the mean and variance of its own input in
    one forward, so the random backbone's activations stay O(1)."""
    from tlxcv_tpu_torch.models.detection.detr import FrozenBatchNorm

    def hook(mod, args):
        xf = args[0].float()
        mod.running_mean.copy_(xf.mean((0, 1, 2)))
        mod.running_var.copy_(xf.var((0, 1, 2), correction=0))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, FrozenBatchNorm)]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()


def test_detr_forward_launches_the_kernel_18_times(cuda):
    """DETR-R50 (``create_model("detr")``) at 256^2 (an 8 x 8 C5 grid): 6
    encoder, 6 decoder self- and 6 cross-attention launches a forward, in
    f32 and bf16; the f32 logits and boxes agree with the CPU's."""
    gen = torch.Generator().manual_seed(5)
    cpu = create_model("detr", device="cpu", generator=gen).eval()
    x = torch.randn(1, 256, 256, 3, generator=gen)
    _frozen_bn_statistics_from_data(cpu, x)
    card = copy.deepcopy(cpu).to(cuda)
    with torch.inference_mode():
        want = cpu(x)
        for dtype in (torch.float32, torch.bfloat16):
            for p in card.parameters():
                p.data = p.data.to(dtype)
            before = flash_attention.launches
            got = card(x.to(cuda, dtype))
            assert flash_attention.launches == before + 18
            assert got["logits"].shape == (1, 100, 92)
            assert torch.isfinite(got["logits"]).all()
            if dtype == torch.float32:
                for key in ("logits", "boxes"):
                    torch.testing.assert_close(
                        got[key].cpu(), want[key],
                        atol=1e-3 * want[key].abs().max(), rtol=0)


# ----------------------------- pose, landmarks, YOLOv3 targets, QAT, resume
@pytest.mark.parametrize("sk", [1041, 1050, 4096])
def test_int8_products_past_1040_keys_on_the_card(cuda, sk):
    """Past the exact f32 range the P.V product sums int32 partials over
    chunks of at most 1040 keys: bitwise the CPU's and the plain int32
    product's, with TF32 on globally."""
    from tlxcv_tpu_torch.nn.attention import (int8_products,
                                              int8_products_plain)

    g = torch.Generator().manual_seed(sk)
    p = torch.randint(0, 128, (2, 3, 50, sk), generator=g, dtype=torch.int8)
    v = torch.randint(-127, 128, (2, 3, sk, 32), generator=g,
                      dtype=torch.int8)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = int8_products(p.to(cuda), v.to(cuda)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    want = int8_products(p, v)
    assert torch.equal(got, want)
    assert torch.equal(want, int8_products_plain(p, v).float())


@pytest.mark.parametrize("iou_thresh", [1.0, 0.5])
def test_yolov3_targets_on_the_card_equal_the_cpus(cuda, iou_thresh):
    """``gt2yolo_targets`` on the card, bitwise the CPU's, on ground
    truths built to share slots (pairs on one centre and size, a centre
    past the image, padding) among random ones: the sequential stamps
    keep the reference's last-writer order on both devices."""
    from tlxcv_tpu_torch.models.detection.yolov3 import (DEFAULT_ANCHORS,
                                                         DEFAULT_MASKS,
                                                         DOWNSAMPLES,
                                                         gt2yolo_targets)

    g = torch.Generator().manual_seed(3)
    boxes = torch.rand(8, 50, 4, generator=g) * 0.5 + 0.05
    boxes[:, 1] = boxes[:, 0] * 1.01
    boxes[:, 2] = boxes[:, 0]
    boxes[:, 3, 0] = 1.02
    boxes[:, 40:] = 0.0
    cls = torch.randint(0, 80, (8, 50), generator=g)
    score = torch.rand(8, 50, generator=g) * (boxes[..., 2] > 0)
    args = (DEFAULT_ANCHORS, DEFAULT_MASKS, DOWNSAMPLES, (416, 416), 80)
    want = gt2yolo_targets(boxes, cls, score, *args, iou_thresh=iou_thresh)
    got = gt2yolo_targets(boxes.to(cuda), cls.to(cuda), score.to(cuda),
                          *args, iou_thresh=iou_thresh)
    for w, t in zip(want, got):
        assert t.device.type == "cuda" and torch.equal(t.cpu(), w)


def test_qat_fake_quant_on_the_card_is_quantize_weights(cuda):
    """On the card the QAT weight fake quant gives codes times scale of
    ``quantize_weights`` bitwise; after ``qat_serving_convert`` the layer
    launches the int8 kernel and agrees with its QAT forward."""
    from tlxcv_tpu_torch.nn.layers import Conv2d, _fake_quant_w
    from tlxcv_tpu_torch.ops.quant import enable_qat, qat_serving_convert

    gen = torch.Generator().manual_seed(4)
    conv = Conv2d(64, 128, 3, padding=1, device="cpu", generator=gen)
    card = copy.deepcopy(conv).to(cuda)
    fq = _fake_quant_w(card.weight.detach()).cpu()
    quantize_weights(conv)
    want = conv._unpacked().float() * conv.w_scale[:, None, None, None]
    assert torch.equal(fq, want)
    enable_qat(card)
    calibrate_activations(card, [torch.randn(2, 16, 16, 64, generator=gen)])
    x = torch.randn(2, 16, 16, 64, generator=gen).to(cuda)
    with torch.inference_mode():
        qat = card(x)
        assert qat_serving_convert(card) == 1
        before = int8_matmul.launches
        got = card(x)
        assert int8_matmul.launches == before + 1
    torch.testing.assert_close(got, qat, rtol=0,
                               atol=1e-5 * qat.abs().max().item())


def test_pose_and_pfld_on_the_card_match_the_cpu(cuda):
    """HRNet-W32 pose at 256x192 and PFLD at 112^2, f32 on the card
    against the CPU within 1e-3 of the largest output, no kernel of
    ours."""
    launches = (flash_attention.launches, int8_matmul.launches)
    for name, shape in (("pose_hrnet_w32", (1, 256, 192, 3)),
                        ("pfld", (2, 112, 112, 3))):
        gen = torch.Generator().manual_seed(6)
        cpu = create_model(name, device="cpu", generator=gen).eval()
        x = torch.randn(*shape, generator=gen)
        card = copy.deepcopy(cpu).to(cuda)
        with torch.inference_mode():
            want = cpu(x)
            got = card(x.to(cuda))
        want = want if name == "pose_hrnet_w32" else want[0]
        got = got if name == "pose_hrnet_w32" else got[0]
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-3 * want.abs().max().item())
    assert (flash_attention.launches, int8_matmul.launches) == launches


def test_trainer_checkpoint_on_the_card(cuda, tmp_path):
    """A Trainer on the card saves its full state and a fresh one restores
    it: every tensor bitwise and back on the card in its dtype."""
    from tlxcv_tpu_torch.tasks import FacialLandmarkDetection
    from tlxcv_tpu_torch.train import Trainer, optimizers

    def trainer(seed):
        task = FacialLandmarkDetection(create_model(
            "pfld", device=cuda, generator=torch.Generator().manual_seed(seed)))
        return Trainer(task, optimizer=optimizers.Adam(1e-3),
                       compute_dtype=torch.bfloat16, ema_decay=0.9,
                       device=cuda, seed=seed)

    gen = torch.Generator().manual_seed(7)
    batch = (torch.randn(4, 112, 112, 3, generator=gen),
             (torch.rand(4, 136, generator=gen),
              torch.rand(4, 3, generator=gen)))
    a = trainer(0)
    for _ in range(2):
        a._train_step(*a._put_batch(batch))
        a.step += 1
    path = str(tmp_path / "state.npz")
    a.save_checkpoint(path)
    b = trainer(1).restore_checkpoint(path)
    assert b.step == 2
    for ta, tb in ((a.params, b.params), (a.ema_params, b.ema_params),
                   (a._opt_state(), b._opt_state()),
                   (a._buffers(), b._buffers())):
        for k, v in ta.items():
            assert tb[k].device == v.device and tb[k].dtype == v.dtype
            assert torch.equal(tb[k], v), k


# ------------------------- head dims the wrapper pads; the segmentation zoo
_PADDED_D = [2, 4, 6, 8, 16, 24, 48, 80, 112]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", _PADDED_D)
@pytest.mark.parametrize("grid", ["bit_encoder", "bit_decoder", "ragged"])
def test_padded_head_dims_match_plain(cuda, dtype, d, grid):
    """A head dim the kernel does not take, zero-padded by the wrapper to
    the next of 32/64/96/128: the output (q's shape, one launch) against
    the plain version at the real D, and the gradients through autograd
    (the pad's and the slice's backward around the backward kernel)
    against ``flash_attention_backward_plain`` at the real D on the
    kernel's output, bitwise over two runs.  Grids: BIT's encoder ([B, 8, 8, D] views of a packed qkv
    projection) and decoder ([B, 8, 1024 queries, D] over 4 keys, views of
    separate projections), and a ragged [6, 77, 65, D]."""
    from tlxcv_tpu_torch.ops.cuda import attention as A

    gen = torch.Generator(device=cuda).manual_seed(d)
    if grid == "bit_encoder":
        packed = torch.randn(2, 8, 3, 8, d, generator=gen, device=cuda)
        q, k, v = packed.to(dtype).permute(2, 0, 3, 1, 4)
    elif grid == "bit_decoder":
        q, k, v = (torch.randn(2, n, 8 * d, generator=gen, device=cuda)
                   .to(dtype).view(2, n, 8, d).transpose(1, 2)
                   for n in (1024, 4, 4))
    else:
        q = torch.randn(6, 77, d, generator=gen, device=cuda).to(dtype)
        k, v = (torch.randn(6, 65, d, generator=gen, device=cuda).to(dtype)
                for _ in range(2))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (A.flash_attention.launches, A.flash_attention_backward.launches)
    out = A.flash_attention(*leaves)
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(
        out.float(), A.flash_attention_plain(q.float(), k.float(), v.float()),
        atol=_TOL[dtype], rtol=0)
    dout = torch.randn(out.shape, generator=gen, device=cuda).to(dtype)
    got = torch.autograd.grad(out, leaves, dout)
    again = torch.autograd.grad(A.flash_attention(*leaves), leaves, dout)
    assert (A.flash_attention.launches - before[0],
            A.flash_attention_backward.launches - before[1]) == (2, 2)
    _, lse = A.flash_attention_plain(q.float(), k.float(), v.float(),
                                     return_lse=True)
    want = A.flash_attention_backward_plain(
        q.float(), k.float(), v.float(), None, None, out.detach().float(),
        lse, dout.float())
    for a, b, w, scale in zip(got, again, want,
                              _bwd_scales(want, k.shape[-2])):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w, rtol=0,
                                   atol=_TOL[dtype] * scale)


def test_padding_leaves_the_kernels_own_head_dims_alone(cuda):
    """At D = 64 the wrapper hands the kernel q, k, v as they are (ViT's
    strided views, no copy): the output is the kernel's own token-major
    store."""
    g = torch.Generator(device=cuda).manual_seed(3)
    packed = torch.randn(2, 50, 3, 4, 64, generator=g, device=cuda)
    q, k, v = packed.to(torch.bfloat16).permute(2, 0, 3, 1, 4)
    out = flash_attention(q, k, v)
    assert out.transpose(1, 2).is_contiguous()


def test_bit_on_the_card_matches_the_cpu_with_17_launches(cuda):
    """BIT at its published width (D = 4 padded to 32) at 64 px: 17 flash
    launches a forward (1 encoder + 2 x 8 decoder), f32 against the
    CPU."""
    gen = torch.Generator().manual_seed(6)
    cpu = create_model("bit", device="cpu", generator=gen).eval()
    t1, t2 = (torch.randn(2, 64, 64, 3, generator=gen) for _ in range(2))
    card = copy.deepcopy(cpu).to(cuda)
    with torch.inference_mode():
        want = cpu(t1, t2)
        before = flash_attention.launches
        got = card(t1.to(cuda), t2.to(cuda)).cpu()
    assert flash_attention.launches == before + 17
    torch.testing.assert_close(got, want, atol=1e-3 * want.abs().max(),
                               rtol=0)


def test_enet_indices_on_the_card_equal_the_cpus(cuda):
    """ENet's argmax pool on a tie-heavy input (ReLU'd small integers):
    the card's values and indices bitwise the CPU's, and the unpool's
    scatter through them."""
    from tlxcv_tpu_torch.ops.image import (max_pool2d_with_argmax,
                                           max_unpool2d)

    gen = torch.Generator().manual_seed(8)
    x = torch.randint(-3, 3, (2, 64, 96, 16), generator=gen).clamp_min(0)
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(dtype)
        want_v, want_i = max_pool2d_with_argmax(xc, 2, 2)
        got_v, got_i = max_pool2d_with_argmax(xc.to(cuda), 2, 2)
        assert torch.equal(got_i.cpu(), want_i)
        assert torch.equal(got_v.cpu(), want_v)
        y = torch.randn(want_v.shape, generator=gen).to(dtype)
        assert torch.equal(
            max_unpool2d(y.to(cuda), got_i, (64, 96)).cpu(),
            max_unpool2d(y, want_i, (64, 96)))


@pytest.mark.parametrize("name", ["BiSeNetV2", "ENet", "FastSCNN"])
def test_segmentation_models_on_the_card_match_the_cpu(cuda, name):
    """The fixed-width segmentation models at 128 px, f32 on the card (TF32
    off) against the CPU; no kernel of ours launched."""
    from tlxcv_tpu_torch.models import segmentation as S

    gen = torch.Generator().manual_seed(9)
    cpu = getattr(S, name)(num_classes=7, device="cpu", generator=gen).eval()
    x = torch.randn(2, 128, 128, 3, generator=gen)
    card = copy.deepcopy(cpu).to(cuda)
    before = (flash_attention.launches, int8_matmul.launches)
    with torch.inference_mode():
        want = cpu(x)
        got = card(x.to(cuda)).cpu()
    assert (flash_attention.launches, int8_matmul.launches) == before
    torch.testing.assert_close(got, want, atol=1e-3 * want.abs().max(),
                               rtol=0)


def _rms(a, b):
    return (a.double() - b.double()).pow(2).mean().sqrt().item()


# (registry name or rs class, keyword arguments, takes a pair); at 64 px
_RS_FCOS = [("FCEarlyFusion", {}, True), ("CDNet", {}, True),
            ("snunet", {}, True), ("DSIFN", {}, True), ("STANet", {}, True),
            ("STANet", {"att_type": "PAM"}, True), ("DSAMNet", {}, True),
            ("FCCDN", {}, True), ("farseg", {"backbone_depth": 18}, False),
            ("RSUNet", {"width": 16}, False), ("fcos_r50", {}, False),
            ("fcos_dcn_r50", {}, False)]


@pytest.mark.parametrize("name,kw,pair", _RS_FCOS,
                         ids=[n + "_" + kw.get("att_type", "")
                              for n, kw, _ in _RS_FCOS])
def test_rs_and_fcos_bf16_on_the_card_match_the_cpu(cuda, name, kw, pair):
    """The remote-sensing models and FCOS in bf16 on the card (float
    parameters bf16, statistics f32) against f32 on the CPU, held to the
    CPU's own bf16 model: random BatchNorm networks are chaotic in bf16
    (PERF.md §2).  FCOS by its head outputs, every level; FCOS-DCN's
    offset convs drawn (zero at init, where every tap samples its own
    pixel), so that its taps fall between pixels and past the border.  No
    kernel of ours is launched."""
    from tlxcv_tpu_torch.models import rs
    from tlxcv_tpu_torch.models.detection.deform import DeformConv2d

    gen = torch.Generator().manual_seed(10)
    build = getattr(rs, name, None) or (
        lambda **k: create_model(name, **k))
    cpu = build(device="cpu", generator=gen, **kw).eval()
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, DeformConv2d):
                m.offset_conv.weight.normal_(0, 0.05, generator=gen)
    x = [torch.randn(2, 64, 64, 3, generator=gen) for _ in range(2 if pair
                                                                else 1)]

    def run(model, xs):
        with torch.inference_mode():
            if name.startswith("fcos"):
                outs, _ = model.head_outputs(*xs)
                return torch.cat([t.float().flatten(1) for lvl in outs
                                  for t in lvl], 1)
            return model(*xs).float()

    def bf16(model):
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
        return model

    want = run(cpu, x)
    want16 = run(bf16(copy.deepcopy(cpu)), [t.bfloat16() for t in x])
    card = bf16(copy.deepcopy(cpu).to(cuda))
    before = (flash_attention.launches, int8_matmul.launches)
    got = run(card, [t.to(cuda, torch.bfloat16) for t in x]).cpu()
    assert (flash_attention.launches, int8_matmul.launches) == before
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rms(got, want) <= 2 * _rms(want16, want) + 1e-6 * want.abs().max()


def test_deform_conv_carries_gradients_on_the_card(cuda):
    """The deformable conv's sampler under autograd: the gradients of the
    input, the offset conv and the projection on the card (f32, TF32 off)
    against the CPU's, with offsets of several pixels, some past the
    border."""
    from tlxcv_tpu_torch.models.detection.deform import DeformConv2d

    gen = torch.Generator().manual_seed(11)
    cpu = DeformConv2d(16, 8, device="cpu", generator=gen)
    with torch.no_grad():
        cpu.offset_conv.weight.normal_(0, 0.3, generator=gen)
        cpu.offset_conv.bias.normal_(0, 2.0, generator=gen)
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(2, 12, 10, 16, generator=gen)
    w = torch.randn(2, 12, 10, 8, generator=gen)

    def grads(model, xs, ws):
        xs = xs.clone().requires_grad_(True)
        (model(xs) * ws).sum().backward()
        return [xs.grad] + [p.grad for p in (model.offset_conv.weight,
                                             model.proj.weight)]

    want = grads(cpu, x, w)
    got = grads(card, x.to(cuda), w.to(cuda))
    for g, e in zip(got, want):
        assert g is not None and bool(g.abs().sum() > 0)
        torch.testing.assert_close(g.cpu(), e, rtol=0,
                                   atol=1e-4 * e.abs().max())


def test_group_norm_in_bf16_on_the_card(cuda):
    """GroupNorm's f32 statistics and affine on a bf16 input: the card's
    bf16 output within one bf16 ulp of the CPU's."""
    from tlxcv_tpu_torch.nn import GroupNorm

    gen = torch.Generator().manual_seed(12)
    cpu = GroupNorm(32, 256, device="cpu")
    with torch.no_grad():
        cpu.weight.uniform_(0.5, 1.5, generator=gen)
        cpu.bias.normal_(0, 1, generator=gen)
    x = (3 * torch.randn(2, 25, 42, 256, generator=gen) + 1).bfloat16()
    want = cpu(x)
    got = copy.deepcopy(cpu).to(cuda)(x.to(cuda)).cpu()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("name,gathers", [("faster_rcnn", 1),
                                          ("cascade_rcnn", 3)])
def test_rcnn_stages_take_the_gather_kernel(cuda, name, gathers,
                                            monkeypatch):
    """A micro Faster or Cascade R-CNN on the card: each box stage's
    RoIAlign takes the gather kernel (1 launch a forward, 3 for Cascade's
    three stages), every call bitwise the plain gather on the same table
    and rows; 3 upsample-adds (the FPN); the detections the CPU's."""
    from tlxcv_tpu_torch.models.classification import resnet18
    from tlxcv_tpu_torch.ops import roi_align
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows, gather_rows_plain
    from tlxcv_tpu_torch.ops.cuda.upsample import upsample_add_fused

    same = []

    def checked(table, idx):
        out = gather_rows(table, idx)
        same.append(torch.equal(out, gather_rows_plain(table, idx)))
        return out

    monkeypatch.setattr(roi_align, "gather_rows", checked)
    gen = torch.Generator().manual_seed(0)
    cpu = create_model(name, device="cpu", num_classes=4, num_proposals=16,
                       pre_nms_top_k=64, detections_per_image=8,
                       box_score_thresh=0.0,
                       backbone=resnet18(num_classes=0, with_pool=False,
                                         device="cpu", generator=gen),
                       generator=gen).eval()
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(2, 128, 128, 3, generator=gen)
    with torch.inference_mode():
        want, want_counts = cpu(x)
        g0, u0 = gather_rows.launches, upsample_add_fused.launches
        got, counts = card(x.to(cuda))
        torch.cuda.synchronize()
    assert gather_rows.launches == g0 + gathers
    assert upsample_add_fused.launches == u0 + 3
    assert len(same) == 2 * gathers and all(same)  # the CPU's, then ours
    assert counts.cpu().tolist() == want_counts.tolist()
    assert (counts > 0).all()
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-3 * want.abs().max())


@pytest.mark.parametrize("name", ["retinanet", "gfl_r50", "tood_r50",
                                  "yolox_nano", "centernet", "ttfnet",
                                  "picodet_lcnet", "solov2_r50"])
def test_zoo_bf16_heads_on_the_card_match_the_cpu(cuda, name):
    """The one-stage detectors and SOLOv2 in bf16 on the card (float
    parameters bf16, statistics f32) against f32 on the CPU by their head
    outputs, held to the CPU's own bf16 model (random BatchNorm networks
    are chaotic in bf16, PERF.md §2); only SOLOv2 launches a kernel of
    ours, its FPN's 3 upsample-adds."""
    from tlxcv_tpu_torch.ops.cuda.upsample import upsample_add_fused

    gen = torch.Generator().manual_seed(16)
    cpu = create_model(name, device="cpu", num_classes=8,
                       generator=gen).eval()
    x = torch.randn(2, 64, 96, 3, generator=gen)

    def run(model, xs):
        with torch.inference_mode():
            outs = model.head_outputs(xs)
        flat = []

        def walk(t):
            if torch.is_tensor(t) and t.is_floating_point():
                flat.append(t.float().flatten(1).cpu())
            elif isinstance(t, (list, tuple)):
                for s in t:
                    walk(s)
        walk(outs)
        return torch.cat(flat, 1)

    def bf16(model):
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
        return model

    want = run(cpu, x)
    want16 = run(bf16(copy.deepcopy(cpu)), x.bfloat16())
    card = bf16(copy.deepcopy(cpu).to(cuda))
    before = upsample_add_fused.launches
    got = run(card, x.to(cuda, torch.bfloat16))
    assert upsample_add_fused.launches - before == (
        3 if name == "solov2_r50" else 0)
    rms = lambda a, b: (a - b).double().pow(2).mean().sqrt()  # noqa: E731
    assert torch.isfinite(got).all()
    assert rms(got, want) <= 1.25 * rms(want16, want)
    assert rms(got, want16) <= 2 ** 0.5 * rms(want16, want)


def test_tnt_attention_takes_the_flash_kernel(cuda, monkeypatch):
    """TNT-S at its published width (depth cut to 2) at b2 224^2 in bf16:
    each block's inner attention (head dim 6, padded to 32) and outer
    attention go through the flash kernel, one launch each, and each
    output matches the plain version on the same inputs within the
    kernel's bf16 bound."""
    from tlxcv_tpu_torch.nn import attention as NA

    calls = []

    def recorded(q, k, v, bias=None, scale=None):
        out = flash_attention(q, k, v, bias=bias, scale=scale)
        calls.append((q, k, v, scale, out))
        return out

    monkeypatch.setattr(NA, "flash_attention", recorded)
    gen = torch.Generator().manual_seed(17)
    model = create_model("tnt_s", depth=2, device="cpu",
                         generator=gen).eval()
    for p in model.parameters():
        p.data = p.data.to(cuda, torch.bfloat16)
    x = torch.randn(2, 224, 224, 3, generator=gen).to(cuda, torch.bfloat16)
    before = flash_attention.launches
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 4 and len(calls) == 4
    assert torch.isfinite(out).all()
    shapes = [tuple(q.shape) for q, *_ in calls]
    assert shapes == [(2 * 196, 4, 16, 6), (2, 6, 197, 64)] * 2
    for q, k, v, scale, got in calls:
        want = flash_attention_plain(q.float(), k.float(), v.float(),
                                     scale=scale)
        err = (got.float() - want).abs().max() / want.abs().max()
        assert err <= _TOL[torch.bfloat16]


def test_se_resnext_grouped_int8_convs_on_the_card_are_bitwise(cuda):
    """SE-ResNeXt-50 32x4d quantized and calibrated on the CPU: each
    grouped 3x3 of its first stage (128 -> 128, 32 groups, 56^2 at 224^2)
    on the card, given the CPU's input to it, launches the int8 GEMM once a
    group and returns the CPU's output bitwise; the whole int8 forward
    launches it 582 times (37 convs, 16 x 32 groups, 33 linears)."""
    gen = torch.Generator().manual_seed(18)
    cpu = create_model("se_resnext50_32x4d", device="cpu",
                       generator=gen).eval()
    x = torch.randn(1, 224, 224, 3, generator=gen)
    assert quantize_weights(cpu) == 86
    assert calibrate_activations(cpu, [x]) == 86
    seen = []
    grouped = [cpu.blocks[i].conv2[0] for i in range(3)]
    handles = [m.register_forward_hook(
        lambda mod, args, out: seen.append((mod, args[0], out)))
        for m in grouped]
    with torch.inference_mode():
        cpu(x)
    for h in handles:
        h.remove()
    card = copy.deepcopy(cpu).to(cuda)
    names = {id(m): p for p, m in cpu.named_modules()}
    mods = dict(card.named_modules())
    assert len(seen) == 3
    with torch.inference_mode():
        for mod, xin, want in seen:
            assert mod.groups == 32 and tuple(xin.shape) == (1, 56, 56, 128)
            before = int8_matmul.launches
            got = mods[names[id(mod)]](xin.to(cuda))
            torch.cuda.synchronize()
            assert int8_matmul.launches == before + 32
            assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
        before = int8_matmul.launches
        logits = card(x.to(cuda, torch.bfloat16))
        torch.cuda.synchronize()
    assert int8_matmul.launches == before + 582
    assert torch.isfinite(logits).all()


def test_retinaface_merges_take_the_upsample_add_kernel(cuda, monkeypatch):
    """RetinaFace-R50 at b1 600^2 on the card in f32: its FPN's two nearest
    merges (19 -> 38, and 38 -> 75, which is not 2x) each launch the
    upsample-add kernel once, bitwise the plain version on the same
    inputs, and the outputs match the CPU's."""
    from tlxcv_tpu_torch.ops import image
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample_add_fused,
                                                   upsample_add_plain)

    calls = []

    def checked(x, skip, mode):
        out = upsample_add_fused(x, skip, mode)
        calls.append((tuple(x.shape[1:3]), tuple(skip.shape[1:3]), mode,
                      torch.equal(out, upsample_add_plain(x, skip, mode))))
        return out

    monkeypatch.setattr(image, "upsample_add_fused", checked)
    gen = torch.Generator().manual_seed(19)
    cpu = create_model("retinaface", device="cpu", generator=gen).eval()
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(1, 600, 600, 3, generator=gen)
    with torch.inference_mode():
        want = cpu(x)
        calls.clear()
        before = upsample_add_fused.launches
        got = card(x.to(cuda))
        torch.cuda.synchronize()
    assert upsample_add_fused.launches == before + 2
    assert calls == [((19, 19), (38, 38), "nearest", True),
                     ((38, 38), (75, 75), "nearest", True)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=1e-3 * w.abs().max())


# TrOCR's grids: a decode step's one query row over the KV cache (32
# slots, a [1, 1, T] bias masking the empty ones) and over the encoder's
# 577 tokens; teacher forcing's shared causal [1, S, S] bias
def _cache_bias(sq, sk, filled, cuda):
    slots = torch.arange(sk, device=cuda)
    return torch.where(slots <= filled, 0.0, -1e9).expand(1, sq, sk) \
        .contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk,filled", [(32, 0), (32, 13), (32, 31),
                                       (577, None), (1, None), (65, 40)])
def test_kernel_at_one_query_row(cuda, dtype, sk, filled):
    g = torch.Generator(device=cuda).manual_seed(sk)
    q = torch.randn(64 * 8, 1, 32, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(64 * 8, sk, 32, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    bias = None if filled is None else _cache_bias(1, sk, filled, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q.float(), k.float(), v.float(), bias)
    torch.testing.assert_close(out.float(), ref, atol=_TOL[dtype], rtol=0)
    if filled is not None and filled < sk - 1:  # the empty slots add nothing
        cut = flash_attention(q, k[:, :filled + 1].contiguous(),
                              v[:, :filled + 1].contiguous())
        torch.testing.assert_close(out.float(), cut.float(),
                                   atol=_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(32, 32), (8, 32), (197, 64), (577, 64)])
def test_kernel_at_a_shared_causal_bias(cuda, dtype, s, d):
    from tlxcv_tpu_torch.models.ocr.trocr import causal_mask

    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(16, s, d, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    bias = causal_mask(s, torch.float32, cuda)[None]
    out = flash_attention(q, k, v, bias=bias)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), bias)
    torch.testing.assert_close(out.float(), ref, atol=_TOL[dtype], rtol=0)
    # row 0 sees only key 0
    torch.testing.assert_close(out[:, 0].float(), v[:, 0].float(),
                               atol=_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d,causal", [
    (2, 8, 32, 32, 32, True),       # the decoder's self-attention
    (2, 8, 32, 577, 32, False),     # its cross-attention over the memory
    (2, 6, 577, 577, 64, False),    # the encoder
])
def test_flash_gradients_at_trocr_training_grids(cuda, dtype, b, h, sq, sk,
                                                 d, causal):
    """q, k and v through the forward and backward kernels at TrOCR's
    teacher-forcing grids ([B, H, S, D] views), against autograd through
    the plain version on the CPU in f32 on the same inputs: f32 within
    1e-4 of each gradient's largest magnitude, bf16 within 2e-2."""
    from tlxcv_tpu_torch.models.ocr.trocr import causal_mask

    g = torch.Generator().manual_seed(sq + sk)
    q = torch.randn(b, h, sq, d, generator=g).to(dtype)
    k, v = (torch.randn(b, h, sk, d, generator=g).to(dtype)
            for _ in range(2))
    gy = torch.randn(b, h, sq, d, generator=g).to(dtype)
    bias = causal_mask(sq, torch.float32, "cpu")[None] if causal else None
    grads = []
    for dev in ("cpu", cuda):
        xs = [t.detach().to(dev, torch.float32 if dev == "cpu" else dtype)
              .requires_grad_() for t in (q, k, v)]
        out = flash_attention(*xs, bias=None if bias is None
                              else bias.to(dev))
        assert out.grad_fn is not None
        out.backward(gy.to(dev, xs[0].dtype))
        grads.append([t.grad.float().cpu() for t in xs])
    for a, c in zip(*grads):
        torch.testing.assert_close(c, a, rtol=0,
                                   atol=_TOL[dtype] * float(a.abs().max()))


@pytest.mark.parametrize("shape,kernel,stride,padding", [
    ((2, 16, 64, 64, 3), 7, 2, "SAME"),        # I3D's stem: pads (2, 3)
    ((2, 8, 28, 28, 64), 3, 1, "SAME"),
    ((1, 5, 9, 11, 8), (3, 1, 2), (1, 2, 1), ((1, 2), (0, 1), (2, 0))),
])
def test_conv3d_on_the_card_matches_the_cpu(cuda, shape, kernel, stride,
                                            padding):
    """``nn.Conv3d`` (lax's "SAME", uneven pads through ``F.pad``) and the
    3-D pools on the card against the CPU: f32 (TF32 off) within 1e-4 of
    the output's largest magnitude, bf16 within 3e-2."""
    from tlxcv_tpu_torch.nn import AvgPool3d, Conv3d, MaxPool3d

    gen = torch.Generator().manual_seed(3)
    cpu = Conv3d(shape[-1], 16, kernel, stride, padding, device="cpu",
                 generator=gen)
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(*shape, generator=gen)
    with torch.no_grad():
        want = cpu(x)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            got = card.to(dtype)(x.to(cuda, dtype))
            assert got.shape == want.shape
            torch.testing.assert_close(got.float().cpu(), want, rtol=0,
                                       atol=tol * float(want.abs().max()))
        for pool in (MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
                     AvgPool3d(3, 2, 1)):
            torch.testing.assert_close(pool(want.to(cuda)).cpu(), pool(want),
                                       rtol=0, atol=1e-6)


def test_trocr_decoding_on_the_card(cuda):
    """A micro TrOCR (encoder 1 layer, decoder 2 layers, max_length 8) in
    f32 on the card: greedy and 3-beam tokens equal the CPU's, the
    teacher-forced logits within 1e-4 of their scale, and exactly 1 + 2 x
    2 x 8 = 33 flash launches a generation (the encoder, then a self- and
    a cross-attention a layer a step) and 1 + 2 x 2 a teacher-forced
    forward."""
    from tlxcv_tpu_torch.models.ocr import TrOCR

    gen = torch.Generator().manual_seed(23)
    cpu = TrOCR(vocab_size=40, encoder_dim=32, encoder_depth=1,
                encoder_heads=2, decoder_dim=64, decoder_depth=2,
                decoder_heads=2, img_size=32, patch_size=8, max_length=8,
                device="cpu", generator=gen).eval()
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(4, 32, 32, 3, generator=gen)
    ids = torch.randint(3, 40, (4, 8), generator=gen)
    before = flash_attention.launches
    greedy = card.generate(x.to(cuda))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 33
    assert torch.equal(greedy.cpu(), cpu.generate(x))
    assert torch.equal(card.generate_beam(x.to(cuda), num_beams=3).cpu(),
                       cpu.generate_beam(x, num_beams=3))
    with torch.no_grad():
        before = flash_attention.launches
        got = card(x.to(cuda), ids.to(cuda))
        assert flash_attention.launches == before + 5
        want = cpu(x, ids)
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_distillation_step_on_the_card(cuda):
    """A DeiT student (micro: 32 px, 8 px patches, width 64, 1 block) takes
    ``teacher_labels`` targets through the Trainer on the card: the dict
    targets reach the card, one flash forward and one backward launch a
    step, a finite loss."""
    from tlxcv_tpu_torch.models.classification.deit import \
        DistilledVisionTransformer
    from tlxcv_tpu_torch.ops.cuda.attention import flash_attention_backward
    from tlxcv_tpu_torch.tasks import DistilledClassification, teacher_labels
    from tlxcv_tpu_torch.train import Trainer, optimizers

    gen = torch.Generator().manual_seed(29)

    def deit():
        return DistilledVisionTransformer(
            img_size=32, patch_size=8, embed_dim=64, depth=1, num_heads=2,
            num_classes=10, device=cuda, generator=gen)

    teacher = deit()
    batches = [(torch.randn(8, 32, 32, 3, generator=gen),
                torch.randint(0, 10, (8,), generator=gen))]
    targets = list(teacher_labels(teacher, batches))
    assert targets[0][1]["teacher"].device.type == "cuda"
    trainer = Trainer(DistilledClassification(deit()), device=cuda,
                      optimizer=optimizers.AdamW(1e-4),
                      compute_dtype=torch.bfloat16)
    x, y = trainer._put_batch(targets[0])
    assert x.is_cuda and y["label"].is_cuda and y["teacher"].is_cuda
    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    loss, _ = trainer._train_step(x, y)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_backward.launches == bwd + 1
    assert torch.isfinite(loss)


def test_trocr_trains_under_the_bf16_policy_on_the_card(cuda):
    """A micro TrOCR's teacher-forced Trainer step in bf16 over f32 masters
    on the card: the loss gets the images cast back to f32, so the decoder
    hands the kernel bf16 queries over an f32 memory, which
    ``scaled_dot_product_attention`` promotes (the kernel takes one dtype);
    one flash forward and one backward launch per attention (1 + 2 x 2),
    the loss within 1e-2 of the same step's on the CPU."""
    from tlxcv_tpu_torch.models.ocr import TrOCR
    from tlxcv_tpu_torch.ops.cuda.attention import flash_attention_backward
    from tlxcv_tpu_torch.tasks import OpticalCharacterRecognition
    from tlxcv_tpu_torch.train import Trainer, optimizers

    gen = torch.Generator().manual_seed(31)
    cpu = OpticalCharacterRecognition(TrOCR(
        vocab_size=40, encoder_dim=32, encoder_depth=1, encoder_heads=2,
        decoder_dim=64, decoder_depth=2, decoder_heads=2, img_size=32,
        patch_size=8, max_length=8, device="cpu", generator=gen))
    card = copy.deepcopy(cpu)
    x = torch.randn(4, 32, 32, 3, generator=gen)
    y = torch.randint(3, 40, (4, 8), generator=gen)
    losses = []
    for task, dev in ((cpu, "cpu"), (card, cuda)):
        trainer = Trainer(task, loss_fn=lambda o, t, m=task: m.loss_fn(o, t),
                          optimizer=optimizers.AdamW(5e-5),
                          compute_dtype=torch.bfloat16, device=dev)
        fwd, bwd = (flash_attention.launches,
                    flash_attention_backward.launches)
        loss, _ = trainer._train_step(*trainer._put_batch((x, y)))
        losses.append(float(loss))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert flash_attention.launches == fwd + 5
            assert flash_attention_backward.launches == bwd + 5
    assert abs(losses[1] - losses[0]) <= 1e-2 * abs(losses[0])


# --------------------------------------------- operators and export (item 14)
def _operator_cases(dev):
    """(name, operator, its plain version, arguments on ``dev``): every
    ``tlxcv`` operator at a shape its kernel takes."""
    from tlxcv_tpu_torch.ops.cuda import attention as A
    from tlxcv_tpu_torch.ops.cuda import gather as G
    from tlxcv_tpu_torch.ops.cuda import matmul as M
    from tlxcv_tpu_torch.ops.cuda import upsample as U

    g = torch.Generator().manual_seed(11)

    def f(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    def q8(*shape):
        return torch.randint(-100, 100, shape, generator=g,
                             dtype=torch.int8).to(dev)

    q, k, v = (f(2, 3, n, 64, dtype=torch.bfloat16) for n in (40, 72, 72))
    a, w = q8(130, 64), q8(48, 64)
    scale, bias = f(48).abs() / 1e3, f(48)
    x, skip = f(2, 5, 7, 16), f(2, 10, 14, 16)
    return [
        ("flash_attention", A.flash_attention_op,
         lambda *t: A._plain_in_kernel_layout(*t, with_lse=False),
         (q, k, v, None, 0.125)),
        ("int8_matmul_nt", M.int8_matmul_nt_op,
         lambda a, w: M.int8_matmul_plain(a, w.t()), (a, w)),
        ("int8_matmul_requant", M.int8_matmul_requant_op,
         M.int8_matmul_requant_plain,
         (a, w, scale, bias, True, torch.tensor(0.05, device=dev),
          torch.float32)),
        ("bf16_matmul", M.bf16_matmul_op, M.bf16_matmul_plain,
         (f(70, 40, dtype=torch.bfloat16), f(40, 24, dtype=torch.bfloat16))),
        ("gather_rows", G.gather_rows_op, G.gather_rows_plain,
         (f(50, 32), torch.randint(0, 50, (33,), generator=g,
                                   dtype=torch.int32).to(dev))),
        ("upsample_add", U.upsample_add_op, U.upsample_add_plain,
         (x, skip, "bilinear")),
        ("upsample2x", U.upsample2x_op, U.upsample2x_plain, (x,)),
    ]


def test_operators_launch_their_kernels_and_match_plain(cuda):
    """Each operator's CUDA implementation launches its kernel (one count)
    and never its plain version; its output against the plain version on
    the same card tensors (bitwise but for flash attention's bf16)."""
    from tlxcv_tpu_torch.ops.cuda import launch_counts, reset_launches

    for name, op, plain, args in _operator_cases(cuda):
        reset_launches()
        got = op(*args)
        torch.cuda.synchronize()
        counts = {k: n for k, n in launch_counts(f32=False).items() if n}
        want = plain(*args)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name == "flash_attention":
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=0)
        else:
            assert torch.equal(got, want), name
        kernel = {"int8_matmul_nt": "int8_matmul",
                  "int8_matmul_requant": "int8_matmul",
                  "upsample_add": "upsample_add_fused",
                  "upsample2x": "upsample2x_fused"}.get(name, name)
        assert counts == {kernel: 1}, (name, counts)


@pytest.mark.parametrize("kind", ["vit", "int8"])
def test_export_on_the_card_replays_the_kernels(cuda, kind, tmp_path):
    """A micro ViT (bf16, 2 flash launches a forward) and a micro int8
    ResNet-18 (21 int8 GEMM launches) exported on the card, saved, loaded,
    served at batches 1 and 3: bitwise the eager model, the same kernels."""
    from tlxcv_tpu_torch.models.classification import vision_transformer
    from tlxcv_tpu_torch.ops.cuda import launch_counts, reset_launches
    from tlxcv_tpu_torch.tasks import ImageClassification
    from tlxcv_tpu_torch.utils.export import (export_model, load_exported,
                                              save_exported)

    torch.manual_seed(0)
    if kind == "vit":
        model = ImageClassification(vision_transformer.VisionTransformer(
            img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=4,
            num_classes=10, qkv_bias=True, device="cpu")).eval()
        model = model.to(cuda, torch.bfloat16)
        dtype, kernel, per = torch.bfloat16, "flash_attention", 2
    else:
        model = create_model("resnet18", device="cpu", num_classes=10).eval()
        quantize_weights(model)
        calibrate_activations(model, [torch.randn(2, 32, 32, 3)])
        model = model.to(cuda)
        dtype, kernel, per = torch.float32, "int8_matmul", 21
    art = export_model(model, (32, 32, 3), dtype=dtype)
    save_exported(str(tmp_path / "m.pt2"), art)
    serve = load_exported(str(tmp_path / "m.pt2"))
    for b in (1, 3):
        x = torch.randn(b, 32, 32, 3, device=cuda).to(dtype)
        with torch.inference_mode():
            want = model(x)
            reset_launches()
            got = serve(x)
            torch.cuda.synchronize()
            counts = {k: n for k, n in launch_counts(f32=False).items() if n}
        assert torch.equal(got, want) and counts == {kernel: per}, counts

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the root of the repository
    python3 chip_smoke.py --profile   # adds per-kernel device-time profiles
                                      # and Mask R-CNN's idle share

Phases, one JSON line each; any failure raises and exits non-zero:

1. environment: the card (nvidia-smi name and power limit), torch and
   CUDA versions; every kernel under tlxcv_tpu_torch/csrc/ is built with
   nvcc for sm_90a, one nvcc per source, all started together.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at the edge cases of its contract, with the
   tolerance and its reason; then the kernel's, the plain version's and
   the library call's times (CUDA events, medians) beside the bound.
3. model: ViT-B/16 at full width and depth, random weights from a seed,
   built by ``create_model`` on the card.  f32 and bf16 logits against
   the same weights run in f32 on the CPU; exactly 12 attention kernel
   launches per forward; then the ViT path, b64 bf16 ``predict``, is
   served and timed.
4. ResNet-50 (``create_model("resnet50")``, random weights and BatchNorm
   statistics from a seed): f32 and bf16 logits on the card against f32
   on the CPU; ``quantize_for_serving`` on the CPU in f32 with 4
   calibration images, as the JAX package's bench does; the int8 model on
   the card against the same int8 model on the CPU (plain int8 GEMM),
   with exactly 54 int8 GEMM launches per forward.  Then both paths,
   b256 bf16 ``predict`` on cuDNN and full int8 through the kernel, are
   served and timed, and the int8 GEMM is timed at every shape of the
   int8 forward.
5. Mask R-CNN (``create_model("mask_rcnn")``: ResNet-50 + FPN, 80
   classes, random weights and BatchNorm statistics from a seed): the row
   gather and the upsample-add kernels against their plain versions first
   (phase 2); then f32 and bf16 at b2 640^2 against f32 on the CPU, stage
   by stage (FPN levels, RPN logits and deltas, box-head and mask logits
   on the CPU's proposals and detections, the share of the CPU's
   detections reproduced, a count > 0 per image); then the bench leg, b16
   640^2 bf16 ``predict``, served and timed with exactly 2 gather and 3
   upsample-add launches per forward, and both kernels timed on the inputs
   one served forward hands them.

Each path is driven with every kernel's launch count set to 0 just before
it and read just after.  The last three lines are the kernels' record, the
card, and the contract line ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,  # dense tensor-core bf16
                  torch.float32: 67e12,    # f32 outside the tensor cores
                  torch.int8: 1979e12}     # dense tensor-core int8


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps=30, warmup=5):
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(bh, s, d, dtype):
    """Least time for one call without bias: q, k, v read once and o
    written once, against the card's memory rate; 4*S*S*D*BH operations
    against its peak rate for the dtype.  Returns (ms, what bounds it)."""
    elt = torch.finfo(dtype).bits // 8
    by_bytes = 4 * bh * s * d * elt / HBM_BYTES_PER_S
    by_ops = 4 * s * s * d * bh / PEAK_OPS_PER_S[dtype]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def qkv(bh, s, d, dtype, seed, heads=None):
    """q, k, v as [bh, s, d] tensors; with ``heads``, as the [B, H, S, D]
    views into one packed [B, S, 3, H, D] projection that a ViT block
    hands the kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if heads is None:
        return [torch.randn(bh, s, d, generator=g, device="cuda").to(dtype)
                for _ in range(3)]
    packed = torch.randn(bh // heads, s, 3, heads, d, generator=g,
                         device="cuda").to(dtype)
    return list(packed.permute(2, 0, 3, 1, 4))


def phase_environment():
    from tlxcv_tpu_torch.ops.cuda import _build

    card = card_line()
    t0 = time.perf_counter()
    _build.build()  # every source under csrc/, in parallel
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln]
             for name, log in _build.build_logs.items()}
    emit({"phase": "environment", "card": card,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    emit({"phase": "build", "sources": _build.sources(),
          "seconds": seconds, "ptxas": ptxas})


def phase_kernels():
    """flash_attention against flash_attention_plain on the card."""
    from tlxcv_tpu_torch.ops.cuda.attention import (flash_attention,
                                                    flash_attention_plain)

    # f32: same arithmetic, other summation order -> 1e-4.  bf16: held
    # against the plain version run in f32 on the same bf16 inputs; P is
    # rounded to bf16 before P.V and the output to bf16 -> 2e-2.
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for dtype in (f32, bf):
        cases += [
            ("vit_b16_b64_packed", 768, 197, 64, dtype, None),
            ("vit_b16_b64", 768, 197, 64, dtype, None),
            ("s577_d64", 96, 577, 64, dtype, None),
            ("d32_bias_per_bh", 64, 197, 32, dtype, "per_bh"),
            ("d32_bias_shared", 64, 197, 32, dtype, "shared"),
            ("d96_vit_s16", 192, 197, 96, dtype, None),
            ("d128", 32, 256, 128, dtype, None),
            ("first_kv_tile_masked", 4, 128, 32, dtype, "block_diag"),
            ("row_fully_masked", 4, 100, 64, dtype, "row0_masked"),
        ]
    results = []
    for i, (name, bh, s, d, dtype, bias_kind) in enumerate(cases):
        q, k, v = qkv(bh, s, d, dtype, seed=i,
                      heads=12 if name.endswith("_packed") else None)
        bias = None
        if bias_kind in ("per_bh", "shared"):
            g = torch.Generator(device="cuda").manual_seed(100 + i)
            bias = torch.randn(bh if bias_kind == "per_bh" else 1, s, s,
                               generator=g, device="cuda")
        elif bias_kind == "block_diag":
            # two 64-key segments: the second segment's queries see their
            # first k/v tile fully masked
            seg = torch.arange(s, device="cuda") // 64
            bias = torch.where(seg[:, None] == seg[None, :], 0.0,
                               float("-inf"))[None]
        elif bias_kind == "row0_masked":
            bias = torch.zeros(1, s, s, device="cuda")
            bias[0, 0, :] = float("-inf")
        out = flash_attention(q, k, v, bias=bias)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q.float(), k.float(), v.float(), bias)
        err = (out.float() - ref).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        results.append({"case": name, "dtype": str(dtype).split(".")[-1],
                        "shape": [bh, s, d], "bias": bias_kind,
                        "max_abs_err": err, "atol": tol[dtype],
                        "finite": finite})
        if not finite or not err <= tol[dtype]:
            emit({"phase": "kernels", "failed": results[-1]})
            raise AssertionError(f"flash_attention {name} {dtype}: "
                                 f"max |err| {err} > {tol[dtype]}")
    emit({"phase": "kernels", "flash_attention": results})

    timings = {}
    for dtype in (bf, f32):
        bh, s, d = 768, 197, 64
        q, k, v = qkv(bh, s, d, dtype, seed=7, heads=12)  # as served
        bound, bound_by = attention_bound_ms(bh, s, d, dtype)
        timings[str(dtype).split(".")[-1]] = {
            "shape": [bh, s, d],
            "ms": time_ms(lambda: flash_attention(q, k, v)),
            "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v)),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v)),
            "bound_ms": bound, "bound_us": 1e3 * bound, "bound_by": bound_by}
    emit({"phase": "kernel_times", "flash_attention": timings})
    main = next(r for r in results
                if r["case"] == "vit_b16_b64_packed"
                and r["dtype"] == "bfloat16")
    return {"name": "flash_attention", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tlxcv_tpu/ops/pallas/attention.py:39",
            "max_abs_err": main["max_abs_err"], **timings["bfloat16"]}


def phase_model(record):
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.ops.cuda.attention import flash_attention
    from tlxcv_tpu_torch.tasks import ImageClassification

    name = "vit_base_patch16_224"
    gen = torch.Generator().manual_seed(0)
    model = ImageClassification(create_model(name, generator=gen)).eval()
    ref = ImageClassification(create_model(name, device="cpu")).eval()
    ref.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    x4 = torch.randn(4, 224, 224, 3, generator=gen)
    with torch.inference_mode():
        want = ref(x4)
        scale = want.abs().max().item()
        got32 = model(x4.cuda()).float().cpu()
        model.to(torch.bfloat16)
        flash_attention.launches = 0
        got16 = model(x4.cuda().to(torch.bfloat16)).float().cpu()
        per_forward = flash_attention.launches
    err32 = (got32 - want).abs().max().item()
    err16 = (got16 - want).abs().max().item()
    # f32 on the card (TF32 off) differs from the CPU by summation order
    # only: 1e-3 of the logit scale.  bf16 rounds every activation and
    # weight to 8 bits of mantissa through 12 blocks: 3e-2 of the scale.
    check = {"logit_scale": scale, "f32_max_abs_err": err32,
             "f32_bound": 1e-3 * scale, "bf16_max_abs_err": err16,
             "bf16_bound": 3e-2 * scale, "launches_per_forward": per_forward}
    emit({"phase": "model_check", "model": name, "batch": 4, **check})
    if not (torch.isfinite(got32).all() and torch.isfinite(got16).all()):
        raise AssertionError("non-finite logits on the card")
    if not (err32 <= 1e-3 * scale and err16 <= 3e-2 * scale):
        raise AssertionError(f"logits disagree with the CPU: {check}")
    if per_forward != 12:
        raise AssertionError(f"{per_forward} attention kernel launches in "
                             f"one forward, expected 12")

    # the ViT path: b64 bf16 predict, served on the card
    x = torch.randn(64, 224, 224, 3, generator=gen).to("cuda", torch.bfloat16)
    counts, _ = serve(model, x, {"flash_attention": 12}, name, "bfloat16")
    record["launches"] = counts["flash_attention"]
    return model, x


# ---------------------------------------------------------------- int8 GEMM
# (name, M, K, N): the main path's shapes at b256 224^2, and the JAX
# package's int8 probe shapes
INT8_SHAPES = [
    ("stem_7x7_b256", 3211264, 147, 64),
    ("layer1_3x3_b256", 802816, 576, 64),
    ("layer4_1x1_b256", 12544, 2048, 512),
    ("fc_b256", 256, 2048, 1000),
    ("probe_4096", 4096, 4096, 4096),
    ("probe_1x1_b64", 200704, 256, 256),
]


def int8_bound_ms(m, k, n):
    """Least time of one [M, K] @ [K, N] int8 -> int32 product: a, b read
    once and the int32 output written once against the card's memory
    rate; 2*M*N*K operations against its dense int8 rate."""
    by_bytes = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S
    by_ops = 2 * m * n * k / PEAK_OPS_PER_S[torch.int8]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def int8_operands(m, k, n, seed, fill=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fill is None:
        return [torch.randint(-127, 128, shape, generator=g, device="cuda",
                              dtype=torch.int8) for shape in ((m, k), (k, n))]
    return [torch.full(shape, v, device="cuda", dtype=torch.int8)
            for shape, v in (((m, k), fill[0]), ((k, n), fill[1]))]


def time_int8_shape(m, k, n, seed, reps=20):
    """Kernel, plain and library ms of one product as the int8 layers
    hand it over: K zero-padded for the kernel, the weight packed [N, Kp].
    The library call is torch._int_mm on the same padded operands; its
    shape rules may refuse them (then null, with its message)."""
    from tlxcv_tpu_torch.ops.cuda.matmul import (int8_matmul_nt,
                                                 int8_matmul_plain, pad_k)

    a, b = int8_operands(m, k, n, seed)
    ap, w = pad_k(a), pad_k(b.t().contiguous())
    out = {"ms": time_ms(lambda: int8_matmul_nt(ap, w), reps=reps),
           "plain_ms": time_ms(lambda: int8_matmul_plain(a, b),
                               reps=max(3, reps // 4), warmup=1)}
    try:
        torch._int_mm(ap, w.t())
        out["library_ms"] = time_ms(lambda: torch._int_mm(ap, w.t()),
                                    reps=reps)
    except RuntimeError as err:
        out["library_ms"] = None
        out["library_refused"] = str(err).splitlines()[0][:160]
    out["bound_ms"], out["bound_by"] = int8_bound_ms(m, k, n)
    return out


def phase_int8_kernels():
    """int8_matmul against int8_matmul_plain on the card, exactly, at the
    main path's shapes and at the edges of its contract; then the times."""
    from tlxcv_tpu_torch.ops.cuda.matmul import (int8_matmul,
                                                 int8_matmul_plain)

    cases = [(name, m, k, n, None) for name, m, k, n in INT8_SHAPES]
    cases += [(f"edge_{m}x{k}x{n}", m, k, n, None)
              for m in (1, 17, 33) for k in (1, 17, 33) for n in (1, 17, 33)]
    cases += [("all_minus_127", 300, 4096, 70, (-127, -127)),
              ("k4096_plus_minus_127", 129, 4096, 65, (127, -127)),
              ("k4096_random_sign", 257, 4096, 130, None)]
    worst = 0
    for i, (name, m, k, n, fill) in enumerate(cases):
        a, b = int8_operands(m, k, n, seed=i, fill=fill)
        if name == "k4096_random_sign":
            a, b = (torch.where(t >= 0, 127, -127).to(torch.int8)
                    for t in (a, b))
        got = int8_matmul(a, b)
        torch.cuda.synchronize()
        want = int8_matmul_plain(a, b)
        err = (got.double() - want.double()).abs().max().item()
        worst = max(worst, err)
        if got.dtype != torch.int32 or err != 0:
            emit({"phase": "int8_kernels", "failed": name,
                  "shape": [m, k, n], "max_abs_err": err})
            raise AssertionError(f"int8_matmul {name} {m}x{k}x{n}: "
                                 f"max |err| {err}, expected exact")
        del a, b, got, want
    emit({"phase": "int8_kernels", "cases": len(cases), "max_abs_err": worst,
          "tolerance": 0, "why": "int32 sums of int8 products are exact"})

    timings = {}
    for i, (name, m, k, n) in enumerate(INT8_SHAPES):
        timings[name] = {"shape": [m, k, n], **time_int8_shape(m, k, n, i)}
        torch.cuda.empty_cache()
    emit({"phase": "kernel_times", "int8_matmul": timings})
    return {"name": "int8_matmul", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "tlxcv_tpu/ops/pallas/matmul.py:32",
            "max_abs_err": worst}


def _counted():
    """Every kernel wrapper that counts its launches, by kernel name."""
    from tlxcv_tpu_torch.ops.cuda.attention import flash_attention
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows
    from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul
    from tlxcv_tpu_torch.ops.cuda.upsample import upsample_add_fused

    return {"flash_attention": flash_attention, "int8_matmul": int8_matmul,
            "gather_rows": gather_rows,
            "upsample_add_fused": upsample_add_fused}


def reset_launches():
    for fn in _counted().values():
        fn.launches = 0


def launches():
    return {name: fn.launches for name, fn in _counted().items()}


def check_labels(pred, batch):
    if pred.shape != (batch,) or not bool(((pred >= 0) & (pred < 1000)).all()):
        raise AssertionError(f"bad predictions {pred.shape}")


def serve(model, x, expect, name, dtype, warmup=3, rounds=10,
          check=check_labels):
    """Time ``predict`` (host clock around each call and a synchronise),
    with the launch counts set to 0 just before and checked just after
    against ``expect`` launches per forward (kernels not named: 0)."""
    torch.cuda.reset_peak_memory_stats()
    times = []
    reset_launches()
    with torch.inference_mode():
        for i in range(warmup + rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred = model.predict(x)
            torch.cuda.synchronize()
            if i >= warmup:
                times.append(time.perf_counter() - t0)
    counts = launches()
    want = {k: expect.get(k, 0) * (warmup + rounds) for k in counts}
    if counts != want:
        raise AssertionError(f"{name} {dtype}: kernel launches {counts}, "
                             f"expected {want}")
    batch = x.shape[0]
    check(pred, batch)
    step = statistics.median(times)
    emit({"phase": "serve", "model": name, "batch": batch, "dtype": dtype,
          "rounds": rounds, "step_ms_median": 1e3 * step,
          "step_ms_all": [1e3 * t for t in times],
          "img_per_s": batch / step, "launches": counts,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    return counts, step


def params_to(model, dtype):
    """Cast the float parameters only, as the JAX package's bench casts
    its params to bf16 and keeps the BatchNorm statistics in f32."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


def phase_resnet(int8_record):
    """ResNet-50: float and int8 logits on the card against the CPU, then
    the two serving paths at b256."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.nn import BatchNorm
    from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul
    from tlxcv_tpu_torch.ops.quant import quantize_for_serving
    from tlxcv_tpu_torch.tasks import ImageClassification

    name = "resnet50"
    gen = torch.Generator().manual_seed(0)
    cpu = ImageClassification(create_model(name, device="cpu",
                                           generator=gen)).eval()
    for mod in cpu.modules():  # non-trivial running statistics
        if isinstance(mod, BatchNorm):
            c = mod.running_mean.shape[0]
            mod.running_mean.copy_(0.2 * torch.randn(c, generator=gen))
            mod.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
    x4 = torch.randn(4, 224, 224, 3, generator=gen)
    card = copy.deepcopy(cpu).cuda()
    with torch.inference_mode():
        want = cpu(x4)
        scale = want.abs().max().item()
        got32 = card(x4.cuda()).cpu()
    params_to(card, torch.bfloat16)
    with torch.inference_mode():
        got16 = card(x4.cuda().to(torch.bfloat16)).float().cpu()
    err32 = (got32 - want).abs().max().item()
    err16 = (got16 - want).abs().max().item()
    # f32 on the card (TF32 off) differs from the CPU by summation order
    # only: 1e-3 of the logit scale.  bf16 rounds every activation and
    # weight to 8 bits of mantissa through 53 convs: 3e-2 of the scale.
    check = {"logit_scale": scale, "f32_max_abs_err": err32,
             "f32_bound": 1e-3 * scale, "bf16_max_abs_err": err16,
             "bf16_bound": 3e-2 * scale}
    emit({"phase": "model_check", "model": name, "batch": 4, **check})
    if not (torch.isfinite(got32).all() and torch.isfinite(got16).all()):
        raise AssertionError("non-finite ResNet-50 logits on the card")
    if not (err32 <= 1e-3 * scale and err16 <= 3e-2 * scale):
        raise AssertionError(f"ResNet-50 logits disagree with the CPU: "
                             f"{check}")

    # full int8: prepared on the CPU in f32, served on the card
    calib = torch.randn(4, 224, 224, 3, generator=gen)
    t0 = time.perf_counter()
    counts = quantize_for_serving(cpu.backbone, [calib])
    prep_s = time.perf_counter() - t0
    card8 = copy.deepcopy(cpu).cuda()
    reset_launches()
    with torch.inference_mode():
        got8 = card8(x4.cuda()).cpu()
        per_forward = int8_matmul.launches
        want8 = cpu(x4)
    fc = cpu.backbone.fc
    step = float(fc.a_scale * 127 * fc.w_scale.max())
    err8 = (got8 - want8).abs().max().item()
    check = {"counts": list(counts), "expected_counts": [53, 54, 54, 32],
             "prep_s": prep_s, "logit_scale": want8.abs().max().item(),
             "max_abs_err": err8, "bound": 4 * step,
             "why": "up to the global pool every op is an exact int32 "
                    "product or an IEEE elementwise op; the pool's f32 "
                    "mean is summed in another order, which can move an "
                    "fc input code by one, each worth at most a_scale * "
                    "127 * max w_scale of the fc: four such codes",
             "launches_per_forward": per_forward}
    emit({"phase": "model_check", "model": name + "_int8", "batch": 4,
          **check})
    if tuple(counts) != (53, 54, 54, 32):
        raise AssertionError(f"quantize_for_serving counts {counts}")
    if not torch.isfinite(got8).all() or not err8 <= 4 * step:
        raise AssertionError(f"int8 ResNet-50 disagrees with the CPU: "
                             f"{check}")
    if per_forward != 54:
        raise AssertionError(f"{per_forward} int8 GEMM launches in one "
                             f"forward, expected 54")
    del cpu, x4

    # the ResNet paths: b256 bf16 predict, float on cuDNN and full int8
    batch = 256
    x = torch.randn(batch, 224, 224, 3, generator=gen).to(
        "cuda", torch.bfloat16)
    serve(card, x, {}, name, "bfloat16")
    counts, _ = serve(card8, x, {"int8_matmul": 54}, name + "_int8",
                      "int8 (bf16 input)")
    int8_record["launches"] = counts["int8_matmul"]
    int8_record.update(int8_forward_times(card8, x))
    return card, card8, x


def int8_forward_times(model, x):
    """The int8 GEMM at every shape one int8 forward hands it (read from
    hooks on the int8 layers), timed alone; summed over the forward."""
    from tlxcv_tpu_torch.nn import Conv2d, Linear

    shapes = []

    def hook(mod, args, out):
        if mod.weight.dtype != torch.int8:
            return
        k = mod.weight.shape[1]  # packed Kp; the function's own K below
        if isinstance(mod, Conv2d):
            k_fn = mod.kernel_size[0] * mod.kernel_size[1] * args[0].shape[-1]
        else:
            k_fn = mod.in_features
        shapes.append((out.numel() // out.shape[-1], k_fn, out.shape[-1], k))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv2d, Linear))]
    with torch.inference_mode():
        model(x)
    for h in handles:
        h.remove()
    distinct = sorted(set(shapes))
    per_shape = []
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    by = {"bytes": 0.0, "operations": 0.0}
    for i, (m, k_fn, n, kp) in enumerate(distinct):
        t = time_int8_shape(m, kp, n, seed=1000 + i, reps=10)
        t["bound_ms"], t["bound_by"] = int8_bound_ms(m, k_fn, n)
        calls = shapes.count((m, k_fn, n, kp))
        per_shape.append({"m": m, "k": k_fn, "kp": kp, "n": n,
                          "calls": calls, **t})
        for key in ("ms", "plain_ms", "bound_ms"):
            total[key] += calls * t[key]
        by[t["bound_by"]] += calls * t["bound_ms"]
        if total["library_ms"] is not None and t["library_ms"] is not None:
            total["library_ms"] += calls * t["library_ms"]
        else:
            total["library_ms"] = None
        torch.cuda.empty_cache()
    emit({"phase": "kernel_times", "int8_matmul_per_forward": {
        "batch": x.shape[0], "calls": len(shapes), "totals_ms": total,
        "shapes": per_shape}})
    return {**total, "bound_by": max(by, key=by.get)}


# ------------------------------------------------------ row gather, upsample
# The main path's shapes at b16 640^2 bf16: the packed pyramid table has
# 16 * 34,000 rows of 4 * 256 channels; the box branch gathers 16 * 256 *
# 7^2 rows, the mask branch 16 * 100 * 14^2.
GATHER_TABLE = (16 * 34_000, 1024)
GATHER_ROWS = {"box_b16": 16 * 256 * 49, "mask_b16": 16 * 100 * 196}
FPN_STEPS = [((16, 20, 20, 256), (40, 40)), ((16, 40, 40, 256), (80, 80)),
             ((16, 80, 80, 256), (160, 160))]


def gather_bound_ms(table, idx):
    """Least time of one gather on this data: each distinct row the indices
    name read once, each output row written once, the indices read once,
    over the memory rate.  Also the data-blind 2 * R * row_bytes form
    (every index its own row)."""
    row = table.shape[1] * table.element_size()
    r = idx.numel()
    distinct = int(torch.unique(idx).numel())
    by_data = (distinct * row + r * row + 4 * r) / HBM_BYTES_PER_S
    return 1e3 * by_data, 1e3 * 2 * r * row / HBM_BYTES_PER_S, distinct


def upsample_bound_ms(x, skip):
    """x and skip read once, the output written once, over the memory rate
    (a few flops per element, far below the compute rate)."""
    return 1e3 * (x.numel() + 2 * skip.numel()) * x.element_size() \
        / HBM_BYTES_PER_S


def phase_gather_kernels():
    """gather_rows against gather_rows_plain on the card, bitwise, at the
    main path's shapes and at the edges of its contract."""
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows, gather_rows_plain

    g = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    big = torch.randn(*GATHER_TABLE, generator=g, device="cuda").to(
        torch.bfloat16)
    for name, r in GATHER_ROWS.items():
        cases.append((name, big, torch.randint(
            0, big.shape[0], (r,), generator=g, device="cuda",
            dtype=torch.int32)))
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.uint8):
        for n, c, r in ((500, 256, 777), (1000, 1024, 4097), (37, 3, 5),
                        (64, 13, 100), (9, 5, 1)):
            if dtype.is_floating_point:
                t = torch.randn(n, c, generator=g, device="cuda").to(dtype)
            else:
                t = torch.randint(0, 100, (n, c), generator=g, device="cuda",
                                  dtype=torch.int32).to(dtype)
            idx = torch.randint(0, n, (r,), generator=g, device="cuda",
                                dtype=torch.int32)
            idx[:4] = torch.tensor([0, n - 1, 0, n - 1][:r])  # repeated, ends
            cases.append((f"{str(dtype)[6:]}_{n}x{c}_r{r}", t, idx))
    results = []
    for name, table, idx in cases:
        got = gather_rows(table, idx)
        torch.cuda.synchronize()
        same = torch.equal(got, gather_rows_plain(table, idx))
        results.append({"case": name, "table": list(table.shape),
                        "rows": idx.numel(), "bitwise": same})
        if not same:
            emit({"phase": "gather_kernels", "failed": results[-1]})
            raise AssertionError(f"gather_rows {name} differs from plain")
    emit({"phase": "gather_kernels", "cases": results, "tolerance": 0,
          "why": "a byte copy"})
    return {"name": "gather_rows", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/gather_rows.cu",
            "replaces": "tlxcv_tpu/ops/pallas/gather.py:36",
            "max_abs_err": 0.0}


def upsample_tolerance(mode, dtype, want):
    """Nearest: bitwise.  Bilinear: the plain version's f32 operations in
    its order without FMA, so bitwise is expected; bound 1e-5 in f32 (the
    reference test's) and one bf16 step of the largest output in bf16."""
    if mode == "nearest":
        return 0.0
    if dtype == torch.float32:
        return 1e-5
    return 2.0 ** -8 * want.float().abs().max().item()


def phase_upsample_kernels():
    """upsample_add_fused against upsample_add_plain on the card, at the
    FPN's b16 shapes and at the edges of its contract."""
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample_add_fused,
                                                   upsample_add_plain)

    g = torch.Generator(device="cuda").manual_seed(12)
    shapes = FPN_STEPS + [((2, 38, 38, 8), (75, 75)),
                          ((2, 38, 38, 256), (75, 75)),
                          ((1, 7, 9, 8), (7, 18)), ((1, 5, 6, 3), (11, 13))]
    results = []
    for xshape, out_hw in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(*xshape, generator=g, device="cuda").to(dtype)
            skip = torch.randn(xshape[0], *out_hw, xshape[3], generator=g,
                               device="cuda").to(dtype)
            for mode in ("nearest", "bilinear"):
                got = upsample_add_fused(x, skip, mode)
                torch.cuda.synchronize()
                want = upsample_add_plain(x, skip, mode)
                err = (got.float() - want.float()).abs().max().item()
                tol = upsample_tolerance(mode, dtype, want)
                results.append({"x": list(xshape), "out_hw": list(out_hw),
                                "dtype": str(dtype)[6:], "mode": mode,
                                "max_abs_err": err, "atol": tol})
                if got.dtype != dtype or not err <= tol:
                    emit({"phase": "upsample_kernels", "failed": results[-1]})
                    raise AssertionError(f"upsample_add_fused {results[-1]}")
    emit({"phase": "upsample_kernels", "cases": results})
    return {"name": "upsample_add_fused", "route": "cuda",
            "source": "tlxcv_tpu_torch/csrc/upsample_add.cu",
            "replaces": "tlxcv_tpu/ops/pallas/upsample.py:117",
            # the main path's calls: nearest, bf16, the FPN's shapes
            "max_abs_err": max(r["max_abs_err"] for r in results
                               if r["mode"] == "nearest"
                               and r["dtype"] == "bfloat16"
                               and [r["x"], r["out_hw"]] in
                               [[list(a), list(b)] for a, b in FPN_STEPS])}


# ------------------------------------------------------------- Mask R-CNN
def _rel(got, want):
    """max |got - want| over max |want|."""
    scale = want.abs().max().item()
    return (got.float().cpu() - want).abs().max().item() / max(scale, 1e-30)


def _box_iou(a, b):
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area = lambda t: (t[:, 2:] - t[:, :2]).clamp_min(0).prod(-1)  # noqa
    return inter / (area(a)[:, None] + area(b)[None, :] - inter + 1e-9)


def matched_share(want, got, labels=True):
    """Share of the reference's valid detections (rows [label, score, x1,
    y1, x2, y2], label -1 for none) that a detection of the card matches:
    the same label (unless ``labels`` is False) and IoU >= 0.9, or every
    coordinate within 0.5 px (random weights give some zero-area boxes,
    whose IoU is 0 even with themselves)."""
    hits = total = 0
    for w, g in zip(want, got):
        w, g = w[w[:, 0] >= 0], g[g[:, 0] >= 0].float().cpu()
        if len(w) == 0:
            continue
        close = (_box_iou(w[:, 2:], g[:, 2:]) >= 0.9) | (
            (w[:, None, 2:] - g[None, :, 2:]).abs().amax(-1) <= 0.5)
        if labels:
            close &= w[:, None, 0] == g[None, :, 0]
        hits += int(close.any(1).sum())
        total += len(w)
    return hits / max(total, 1)


def as_dets(boxes, valid):
    """Boxes [N, R, 4] with a validity mask as detection rows (label 0)."""
    return torch.cat([torch.where(valid, 0.0, -1.0)[..., None].float(),
                      torch.zeros_like(valid, dtype=torch.float32)[..., None],
                      boxes.float()], -1)


# bounds, relative to the largest reference value of each stage: f32 on the
# card (TF32 off) differs from the CPU by summation order only; bf16 rounds
# weights and activations to 8 bits through ~60 convolutions
MRCNN_BOUND = {"float32": 1e-3, "bfloat16": 5e-2}
# share of the CPU's detections the card must reproduce (same label and
# box).  f32 moves a logit by ~1e-5 of its scale, which reorders only
# near-ties.  bf16 moves the RPN logits by ~3% of their scale; with random
# weights (the RPN's convs drawn at std 0.01) the objectness logits of the
# 102,300 anchors lie close together, so the pre-NMS top 512 and the
# proposals after NMS change: 58% of the CPU's proposals and 49% of its
# detections were reproduced at seed 0, labels agreeing wherever boxes do
# (0.5 was predicted and first set as the floor).  A wrong kernel or
# layout reproduces almost none, so 0.25 still tells a working path from
# a broken one; the label-free share and the proposals' share are
# reported beside it, and the heads are held stage by stage above.
MRCNN_SHARE_FLOOR = {"float32": 0.9, "bfloat16": 0.25}


def mrcnn_stages(model, x, props=None, det_boxes=None):
    """The staged outputs of one forward: FPN levels, RPN logits and deltas,
    proposals, detections, counts and masks; box-head logits on ``props``
    and mask logits on ``det_boxes`` (the model's own when not given)."""
    with torch.inference_mode():
        feats, logits, deltas, _, p, pmask = model.forward_features(x)
        cls, bdel = model.box_logits(feats, p)
        dets, counts, masks = model._postprocess(feats, p, pmask, cls, bdel,
                                                 x.shape[1:3])
        if props is not None:
            cls, bdel = model.box_logits(feats, props)
        mlog = model.mask_logits(feats, dets[..., 2:6] if det_boxes is None
                                 else det_boxes)
    return {"feats": feats, "rpn_logits": logits, "rpn_deltas": deltas,
            "props": p, "pmask": pmask, "cls_logits": cls, "box_deltas": bdel,
            "dets": dets, "counts": counts, "masks": masks,
            "mask_logits": mlog}


def phase_mask_rcnn(gather_record, upsample_record):
    """Mask R-CNN (``create_model("mask_rcnn")``, ResNet-50 + FPN, 80
    classes, random weights and BatchNorm statistics from a seed): staged
    f32 and bf16 checks at b2 640^2 against f32 on the CPU, then the
    bench leg, b16 640^2 bf16 ``predict``, served and timed."""
    from tlxcv_tpu_torch import create_model
    from tlxcv_tpu_torch.nn import BatchNorm
    from tlxcv_tpu_torch.tasks import ObjectDetection

    name = "mask_rcnn"
    gen = torch.Generator().manual_seed(0)
    # box_score_thresh=0: with random weights a class probability sits near
    # 1/81, under the leg's 0.05, and no detection would be left to compare
    card = create_model(name, generator=gen, box_score_thresh=0.0).eval()
    for mod in card.modules():
        if isinstance(mod, BatchNorm):
            c = mod.running_mean.shape[0]
            mod.running_mean.copy_(0.2 * torch.randn(c, generator=gen))
            mod.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
    cpu = create_model(name, device="cpu", box_score_thresh=0.0).eval()
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    x2 = torch.randn(2, 640, 640, 3, generator=gen)
    t0 = time.perf_counter()
    want = mrcnn_stages(cpu, x2)
    cpu_s = time.perf_counter() - t0
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16:
            params_to(card, dtype)
        dname = str(dtype)[6:]
        got = mrcnn_stages(card, x2.to("cuda", dtype),
                           props=want["props"].cuda(),
                           det_boxes=want["dets"][..., 2:6].cuda())
        errs = {f"P{i + 2}": _rel(g, w)
                for i, (g, w) in enumerate(zip(got["feats"], want["feats"]))}
        errs.update({k: _rel(got[k], want[k]) for k in
                     ("rpn_logits", "rpn_deltas", "cls_logits", "box_deltas",
                      "mask_logits")})
        counts = got["counts"].cpu().tolist()
        share = matched_share(want["dets"], got["dets"])
        box_share = matched_share(want["dets"], got["dets"], labels=False)
        prop_share = matched_share(as_dets(want["props"], want["pmask"]),
                                   as_dets(got["props"], got["pmask"]))
        finite = all(bool(torch.isfinite(got[k]).all())
                     for k in ("dets", "masks", "cls_logits"))
        check = {"phase": "model_check", "model": name, "batch": 2,
                 "dtype": dname, "rel_max_abs_err": errs,
                 "bound": MRCNN_BOUND[dname], "counts": counts,
                 "cpu_counts": want["counts"].tolist(),
                 "matched_share": share,
                 "share_floor": MRCNN_SHARE_FLOOR[dname],
                 "box_share_any_label": box_share,
                 "proposal_share": prop_share,
                 "pmask_equal_share": (got["pmask"].cpu() == want["pmask"])
                 .float().mean().item(), "finite": finite,
                 "cpu_reference_s": cpu_s,
                 "heads_on": "the CPU's proposals and detections"}
        emit(check)
        if not finite or min(counts) <= 0:
            raise AssertionError(f"Mask R-CNN {dname}: {check}")
        if max(errs.values()) > MRCNN_BOUND[dname]:
            raise AssertionError(f"Mask R-CNN {dname} stages disagree with "
                                 f"the CPU: {errs}")
        if share < MRCNN_SHARE_FLOOR[dname]:
            raise AssertionError(f"Mask R-CNN {dname}: {share} of the CPU's "
                                 f"detections matched")
    del cpu, want, got

    # the bench leg: b16 640^2 bf16, the leg's own score threshold
    card.box_score_thresh = 0.05
    task = ObjectDetection(card)
    x = torch.randn(16, 640, 640, 3, generator=gen).to("cuda", torch.bfloat16)

    def check_dets(out, batch):
        dets, counts, masks = out
        if dets.shape != (batch, 100, 6) or masks.shape != (batch, 100, 28,
                                                            28):
            raise AssertionError(f"bad Mask R-CNN outputs {dets.shape} "
                                 f"{masks.shape}")
        if not (torch.isfinite(dets).all() and torch.isfinite(masks).all()):
            raise AssertionError("non-finite Mask R-CNN outputs")

    counts, step = serve(task, x, {"gather_rows": 2, "upsample_add_fused": 3},
                         name, "bfloat16", check=check_dets)
    gather_record["launches"] = counts["gather_rows"]
    upsample_record["launches"] = counts["upsample_add_fused"]
    mrcnn_kernel_times(task, x, gather_record, upsample_record)
    return task, x, step


def mrcnn_kernel_times(task, x, gather_record, upsample_record):
    """Both kernels timed alone on the inputs one served forward hands
    them (captured by wrapping the wrappers, outside any counted run),
    with their plain versions, the library calls and the bounds; summed
    over the forward."""
    import tlxcv_tpu_torch.ops.image as image
    import tlxcv_tpu_torch.ops.roi_align as roi_align
    from tlxcv_tpu_torch.ops.cuda.gather import gather_rows, gather_rows_plain
    from tlxcv_tpu_torch.ops.cuda.upsample import (upsample_add_fused,
                                                   upsample_add_plain)

    seen = {"gather": [], "upsample": []}
    roi_align.gather_rows = lambda t, i: (
        seen["gather"].append((t, i)) or gather_rows(t, i))
    image.upsample_add_fused = lambda a, b, mode: (
        seen["upsample"].append((a, b, mode)) or upsample_add_fused(a, b,
                                                                     mode))
    try:
        with torch.inference_mode():
            task.predict(x)
    finally:
        roi_align.gather_rows = gather_rows
        image.upsample_add_fused = upsample_add_fused
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    rows = []
    for (table, idx), branch in zip(seen["gather"], ("box", "mask")):
        bound, bound_2r, distinct = gather_bound_ms(table, idx)
        rows.append({"branch": branch, "table": list(table.shape),
                     "rows": idx.numel(), "distinct_rows": distinct,
                     "ms": time_ms(lambda: gather_rows(table, idx)),
                     "plain_ms": time_ms(lambda: gather_rows_plain(table,
                                                                   idx)),
                     "library_ms": time_ms(
                         lambda: torch.index_select(table, 0, idx)),
                     "bound_ms": bound, "bound_ms_2_r_row_bytes": bound_2r})
    gather_record.update({k: sum(r[k] for r in rows) for k in keys},
                         bound_by="bytes")
    emit({"phase": "kernel_times", "gather_rows_per_forward": rows})
    del seen["gather"]
    rows = []
    for a, b, mode in seen["upsample"]:
        size = tuple(b.shape[1:3])

        def library(a=a, b=b, mode=mode, size=size):
            up = torch.nn.functional.interpolate(a.permute(0, 3, 1, 2),
                                                 size=size, mode=mode)
            return up.permute(0, 2, 3, 1) + b

        rows.append({"x": list(a.shape), "skip": list(b.shape), "mode": mode,
                     "dtype": str(a.dtype)[6:],
                     "ms": time_ms(lambda: upsample_add_fused(a, b, mode)),
                     "plain_ms": time_ms(lambda: upsample_add_plain(a, b,
                                                                    mode)),
                     "library_ms": time_ms(library),
                     "bound_ms": upsample_bound_ms(a, b)})
    upsample_record.update({k: sum(r[k] for r in rows) for k in keys},
                           bound_by="bytes")
    emit({"phase": "kernel_times", "upsample_add_fused_per_forward": rows})
    torch.cuda.empty_cache()


def phase_profile(name, model, x, forwards=3, step_s=None):
    """Device time per kernel over a few forwards (torch.profiler), for
    the breakdown of the step; with the served step's wall time, the share
    of it the card spends idle."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model.predict(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                model.predict(x)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)  # microseconds
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:30]
    device_ms = total / forwards / 1e3
    idle = None if step_s is None else 1 - device_ms / (1e3 * step_s)
    emit({"phase": "profile", "model": name, "batch": x.shape[0],
          "forwards": forwards, "device_ms_per_forward": device_ms,
          "serve_step_ms": None if step_s is None else 1e3 * step_s,
          "idle_share": idle,
          "top": [[e.key[:120], e.count // forwards,
                   e.self_device_time_total / forwards / 1e3,
                   e.self_device_time_total / total if total else None]
                  for e in top]})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    flash = phase_kernels()
    int8 = phase_int8_kernels()
    gather = phase_gather_kernels()
    upsample = phase_upsample_kernels()
    vit, vit_x = phase_model(flash)
    resnet16, resnet8, resnet_x = phase_resnet(int8)
    mrcnn, mrcnn_x, mrcnn_step = phase_mask_rcnn(gather, upsample)
    if "--profile" in sys.argv[1:]:
        phase_profile("vit_base_patch16_224", vit, vit_x)
        phase_profile("resnet50", resnet16, resnet_x)
        phase_profile("resnet50_int8", resnet8, resnet_x)
        phase_profile("mask_rcnn", mrcnn, mrcnn_x, step_s=mrcnn_step)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{key: r[key] for key in keys}
                      for r in (flash, int8, gather, upsample)]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

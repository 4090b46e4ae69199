#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the root of the repository
    python3 chip_smoke.py --profile   # adds per-kernel device-time profiles

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
    counts = serve(model, x, {"flash_attention": 12, "int8_matmul": 0}, name,
                   "bfloat16")
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


def reset_launches():
    from tlxcv_tpu_torch.ops.cuda.attention import flash_attention
    from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul

    flash_attention.launches = 0
    int8_matmul.launches = 0


def launches():
    from tlxcv_tpu_torch.ops.cuda.attention import flash_attention
    from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul

    return {"flash_attention": flash_attention.launches,
            "int8_matmul": int8_matmul.launches}


def serve(model, x, expect, name, dtype, warmup=3, rounds=10):
    """Time ``predict`` (host clock around each call and a synchronise),
    with the launch counts set to 0 just before and checked just after
    against ``expect`` launches per forward."""
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
    want = {k: v * (warmup + rounds) for k, v in expect.items()}
    if counts != want:
        raise AssertionError(f"{name} {dtype}: kernel launches {counts}, "
                             f"expected {want}")
    batch = x.shape[0]
    if pred.shape != (batch,) or not bool(((pred >= 0) & (pred < 1000)).all()):
        raise AssertionError(f"bad predictions {pred.shape}")
    step = statistics.median(times)
    emit({"phase": "serve", "model": name, "batch": batch, "dtype": dtype,
          "rounds": rounds, "step_ms_median": 1e3 * step,
          "step_ms_all": [1e3 * t for t in times],
          "img_per_s": batch / step, "launches": counts,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    return counts


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
    serve(card, x, {"flash_attention": 0, "int8_matmul": 0}, name,
          "bfloat16")
    counts = serve(card8, x, {"flash_attention": 0, "int8_matmul": 54},
                   name + "_int8", "int8 (bf16 input)")
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


def phase_profile(name, model, x, forwards=3):
    """Device time per kernel over a few forwards (torch.profiler), for
    the breakdown of the step."""
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
    emit({"phase": "profile", "model": name, "batch": x.shape[0],
          "forwards": forwards,
          "device_ms_per_forward": total / forwards / 1e3,
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
    vit, vit_x = phase_model(flash)
    resnet16, resnet8, resnet_x = phase_resnet(int8)
    if "--profile" in sys.argv[1:]:
        phase_profile("vit_base_patch16_224", vit, vit_x)
        phase_profile("resnet50", resnet16, resnet_x)
        phase_profile("resnet50_int8", resnet8, resnet_x)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{key: r[key] for key in keys} for r in (flash, int8)]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

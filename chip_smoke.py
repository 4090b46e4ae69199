#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the root of the repository
    python3 chip_smoke.py --profile   # adds a per-kernel device-time profile

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
   launches per forward; then the main path, b64 bf16 ``predict``, is
   served and timed.

The last three lines are the kernels' record, the card, and the contract
line ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,  # dense tensor-core bf16
                  torch.float32: 67e12}    # f32 outside the tensor cores


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

    # the main path: b64 bf16 predict, served on the card
    batch, warmup, rounds = 64, 3, 10
    x = torch.randn(batch, 224, 224, 3, generator=gen).to(
        "cuda", torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    times = []
    with torch.inference_mode():
        for i in range(warmup + rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred = model.predict(x)
            torch.cuda.synchronize()
            if i >= warmup:
                times.append(time.perf_counter() - t0)
    launches = flash_attention.launches
    if launches != 12 * (warmup + rounds):
        raise AssertionError(f"{launches} attention kernel launches in "
                             f"{warmup + rounds} forwards")
    if pred.shape != (batch,) or not bool(((pred >= 0) & (pred < 1000)).all()):
        raise AssertionError(f"bad predictions {pred.shape}")
    step = statistics.median(times)
    emit({"phase": "serve", "model": name, "batch": batch,
          "dtype": "bfloat16", "rounds": rounds, "step_ms_median": 1e3 * step,
          "step_ms_all": [1e3 * t for t in times],
          "img_per_s": batch / step, "launches": launches,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    record["launches"] = launches
    return model, x


def phase_profile(model, x, forwards=3):
    """Device time per kernel over a few b64 bf16 forwards
    (torch.profiler), for the breakdown of the step."""
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    emit({"phase": "profile", "forwards": forwards,
          "device_ms_per_forward": total / forwards / 1e3,
          "top": [[e.key[:90], e.count // forwards,
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
    record = phase_kernels()
    model, x = phase_model(record)
    if "--profile" in sys.argv[1:]:
        phase_profile(model, x)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{key: record[key] for key in keys}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

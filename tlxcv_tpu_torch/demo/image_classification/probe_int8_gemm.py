"""GEMM probe: the port's hand-written int8 and bf16 kernels against
PyTorch's own products on the card.

Port of ``demo/image_classification/probe_int8_pallas.py``, which times the
hand-tiled Pallas int8 matmul and its bf16 twin against XLA's dot.  Here
the kernels are ``csrc/int8_matmul.cu`` and ``csrc/bf16_matmul.cu``
(``ops.cuda.matmul``), and one PyTorch call stands where the reference's
XLA dot stands:

1. int8 N^3 (N = 4096): ``int8_matmul_nt``, with the right operand packed
   once as [N, K] as the int8 layers hold their weight, against
   ``torch._int_mm``;
2. bf16 N^3: ``bf16_matmul`` against ``torch.matmul`` in bf16, f32
   accumulation (PyTorch's reduced-precision bf16 reductions off);
3. ResNet's 1x1-conv-as-dot shape, 200704 x 256 . 256 x 256 int8 (batch
   64 at 56^2): the int8 kernel against ``torch._int_mm``.

Each entry is a rate, 2*M*N*K operations over the median time of ``reps``
calls after ``WARMUP`` calls: TFLOP/s for bf16, TOP/s for int8.  On the card the
calls are timed with CUDA events; on the CPU, where every wrapper runs its
plain version, with the host clock, and the rate says nothing about a
device.  The reference's block-size sweeps are not carried: the port's
kernels take no TPU block sizes.  The int8 kernel's product is checked
against ``torch._int_mm`` once per shape (both exact).

    python -m tlxcv_tpu_torch.demo.image_classification.probe_int8_gemm \\
        [--device cpu] [--n 4096] [--m-1x1 200704] [--reps 20] [--out FILE]

prints one JSON line (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ...device import resolve_device
from ...ops.cuda.matmul import bf16_matmul, int8_matmul_nt, pad_k

__all__ = ["main", "run"]

WARMUP = 3


def _median_ms(fn, device, reps):
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _int8(m, k, n, gen, device):
    return [torch.randint(-127, 128, shape, generator=gen,
                          dtype=torch.int8).to(device)
            for shape in ((m, k), (k, n))]


def run(device=None, n=4096, m_1x1=200704, reps=20):
    """The three configurations' rates (and their times in ``ms``), on
    operands drawn from seed 0."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    rates, ms = {}, {}

    def timed(key, fn, flops):
        ms[key] = _median_ms(fn, device, reps)
        rates[key] = flops / (ms[key] * 1e-3) / 1e12

    def int8_pair(name, m, k, nn):
        a, b = _int8(m, k, nn, gen, device)
        ap, w = pad_k(a), pad_k(b.t().contiguous())  # w: the packed weight
        if not torch.equal(int8_matmul_nt(ap, w), torch._int_mm(a, b)):
            raise AssertionError(f"int8 kernel differs from torch._int_mm "
                                 f"at {m}x{k}x{nn}")
        flops = 2.0 * m * k * nn
        timed(f"cuda_{name}_int8", lambda: int8_matmul_nt(ap, w), flops)
        timed(f"torch_int_mm_{name}_int8", lambda: torch._int_mm(a, b),
              flops)

    int8_pair("dot", n, n, n)

    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        a, b = (torch.randn(n, n, generator=gen).to(device, torch.bfloat16)
                for _ in range(2))
        timed("cuda_dot_bf16", lambda: bf16_matmul(a, b), 2.0 * n ** 3)
        timed("torch_matmul_bf16", lambda: torch.matmul(a, b), 2.0 * n ** 3)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            saved
    del a, b

    int8_pair("1x1dot", m_1x1, 256, 256)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    return {"probe": "int8_gemm", "device": kind, "n": n, "m_1x1": m_1x1,
            "reps": reps, "units": "TFLOP/s (bf16), TOP/s (int8)", **rates,
            "ms": ms}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--n", type=int, default=4096)
    parser.add_argument("--m-1x1", type=int, default=200704)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    result = run(device=args.device, n=args.n, m_1x1=args.m_1x1,
                 reps=args.reps)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()

"""What holds the SSD chunk-scan kernel back: edited copies of
``csrc/ssd.cu`` measured beside the shipped one on the same card.

    python -m repro_torch.bench.ssd_probe [--out FILE.json]

Each variant below is one named edit of the source, compiled with ``nvcc``
into a library of its own and launched through its ``extern "C"``
launcher on the same operands (the main path's shapes, ``SHAPES``):

- ``tensor_core_sums``: the partial sums are dropped and every product
  accumulates in the tensor cores' own accumulator (which truncates), for
  the error that the partial sums avoid;
- ``no_split``: operands reach the tensor cores unsplit (wrong values; for
  the time the split costs);
- ``no_loads``: the k slices after the first ring fill are not loaded
  (wrong values; for the time the loads cost);
- ``one_product``: only a_hi·b_hi of the three products runs (wrong
  values; for the time the tensor cores cost).

It prints, and writes as JSON with ``--out``: the card's sustained
``mma.sync`` m16n8k8 TF32 rate (independent chains, no memory traffic);
for each variant, the largest error of y and of the final state in f32
ulps of the largest element (against the plain version), each kernel's
device time (``torch.profiler``) and the whole launch's time (CUDA
events); and, for the shipped kernel and ``tensor_core_sums``, the error of
each product alone on one chunk. Runs only on a card with ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from ..kernels import build
from ..kernels.ssd import KERNELS, ssd_chunk_scan_ref

#: the main path's (B, H, C, Q, P, N): mamba2-130m serving, zamba2-2.7b train
SHAPES = {"mamba2 serving": (4, 24, 128, 256, 64, 128),
          "zamba2 train": (1, 80, 32, 128, 64, 64)}

#: variant -> [(text of csrc/ssd.cu, its replacement)]
EDITS = {
    "shipped": [],
    "tensor_core_sums": [
        ("    Acc part;\n    zero(part);", "    Acc& part = acc;"),
        ("        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += "
         "part[mt][nt][e];", "        {}")],
    "no_split": [
        ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;",
         "  hi = __float_as_uint(x);\n  lo = hi;")],
    "no_loads": [
        ("    if (next < steps) load(next, ring + (next % kStages) * kStage);",
         "")],
    "one_product": [
        ("          mma_tf32(part[mt][nt], al[mt], bh[f][nt][0], "
         "bh[f][nt][1]);",
         "          part[mt][nt][0] += __uint_as_float(al[mt][0] ^ "
         "al[mt][1] ^ al[mt][2] ^ al[mt][3]);"),
        ("          mma_tf32(part[mt][nt], ah[f][mt], bl[nt][0], "
         "bl[nt][1]);",
         "          part[mt][nt][1] += __uint_as_float(bl[nt][0] ^ "
         "bl[nt][1]);")],
}

_MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_rate(float* out, int iters) {
  uint32_t a[4];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  const uint32_t b0 = __float_as_uint(0.5f), b1 = __float_as_uint(0.25f);
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
            "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.0f;
  for (int c = 0; c < 8; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_mma_rate(void* out, int blocks, int iters) {
  mma_rate<<<blocks, 128>>>(static_cast<float*>(out), iters);
  return cudaGetLastError();
}
"""


def _compile(src: str, out: Path) -> ctypes.CDLL:
    cu = out.with_suffix(".cu")
    cu.write_text(src, encoding="utf-8")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                           str(out), str(cu)], text=True, capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out))


def variant_source(name: str) -> str:
    """``csrc/ssd.cu`` with the variant's edits; raises if an edit no
    longer matches the source."""
    src = (build.CSRC / "ssd.cu").read_text(encoding="utf-8")
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: edit {old[:60]!r} matches "
                             f"{src.count(old)} places in ssd.cu")
        src = src.replace(old, new)
    return src


def _launcher(lib: ctypes.CDLL):
    fn = lib.rt_ssd_chunk_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 6
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(xdt, bm, cm, cum, h0=None):
        b, h, c, q, p = xdt.shape
        n = bm.shape[-1]
        y = torch.empty_like(xdt)
        h_out = xdt.new_empty((b, h, p, n))
        scores = xdt.new_empty((b, c, q, q))
        states = xdt.new_empty((b, h, c, p, n))
        rc = fn(xdt.data_ptr(), bm.data_ptr(), cm.data_ptr(), cum.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(),
                h_out.data_ptr(), scores.data_ptr(), states.data_ptr(), b, h,
                c, q, p, n, xdt.device.index,
                build.current_stream_ptr(xdt.device.index))
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return y, h_out, scores
    return run


def _inputs(gen, b, h, c, q, p, n, with_h0=False):
    """chip_smoke.py's distributions: x·dt, B, C ~ 0.5 N(0, 1), cum the
    within-chunk cumsum of -U(0.01, 0.2), h0 ~ N(0, 1)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    step = 0.01 + 0.19 * torch.rand((b, h, c, q), generator=gen,
                                    device="cuda")
    return (0.5 * randn(b, h, c, q, p), 0.5 * randn(b, c, q, n),
            0.5 * randn(b, c, q, n), torch.cumsum(-step, dim=-1),
            randn(b, h, p, n) if with_h0 else None)


def _ulps(got, want) -> float:
    """Largest error in f32 ulps (2**-23) of the largest element."""
    return float((got - want).abs().max()) / (
        2.0 ** -23 * float(want.abs().max()))


def _ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, names=KERNELS, calls: int = 3) -> dict:
    """Device milliseconds per call of each kernel whose name holds one of
    ``names``, over ``calls`` calls of ``fn`` (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.name:
                    out[name] += e.time_range.elapsed_us() / 1e3 / calls
    return out


def mma_rate(work: Path) -> dict:
    """Sustained mma.sync m16n8k8 TF32 rate: 16 warps an SM, 8 independent
    accumulator chains a warp."""
    lib = _compile(_MMA_RATE_SRC, work / "mma_rate.so")
    lib.run_mma_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 4, 4096
    out = torch.empty(blocks * 128, device="cuda")
    ms = _ms(lambda: lib.run_mma_rate(out.data_ptr(), blocks, iters), 3)
    mmas = blocks * 4 * iters * 8
    return {"tflops_tf32": mmas * 2048 / ms / 1e9,
            "mma_per_us_per_sm": mmas / sms / (ms * 1e3)}


def probe() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the SSD probe runs on a card: "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(tempfile.mkdtemp(prefix="ssd_probe_"))
    report = {"device": torch.cuda.get_device_name(0),
              "mma_sync_tf32": mma_rate(work), "variants": {}}
    runs = {name: _launcher(_compile(variant_source(name),
                                     work / f"ssd_{name}.so"))
            for name in EDITS}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, shape in SHAPES.items():
        xdt, bm, cm, cum, _ = _inputs(gen, *shape)
        want_y, want_h = ssd_chunk_scan_ref(xdt, bm, cm, cum,
                                            return_state=True)
        for name, run in runs.items():
            y, h_out, _ = run(xdt, bm, cm, cum)
            row = report["variants"].setdefault(name, {})
            row[label] = {
                "y_ulps": _ulps(y, want_y), "state_ulps": _ulps(h_out, want_h),
                "ms": _ms(lambda: run(xdt, bm, cm, cum)),
                "device_ms": kernel_ms(lambda: run(xdt, bm, cm, cum))}
        del xdt, bm, cm, cum, want_y, want_h
        torch.cuda.empty_cache()
    # each product alone, one chunk at the main shapes' widths
    for label, (b, h, _, q, p, n) in SHAPES.items():
        xdt, bm, cm, cum, h0 = _inputs(gen, b, h, 1, q, p, n, True)
        lower = torch.ones(q, q, device="cuda").tril().bool()
        want_s = cm[:, 0] @ bm[:, 0].transpose(-1, -2)
        want_y, want_h = ssd_chunk_scan_ref(xdt, bm, cm, cum,
                                            return_state=True)
        zero = torch.zeros_like(xdt)
        want_inter = ssd_chunk_scan_ref(zero, bm, cm, cum, h0=h0)
        for name in ("shipped", "tensor_core_sums"):
            run = runs[name]
            y, h_out, scores = run(xdt, bm, cm, cum)
            inter, _, _ = run(zero, bm, cm, cum, h0)
            report["variants"][name].setdefault("products", {})[label] = {
                "C·Bᵀ": _ulps(torch.where(lower, scores[:, 0], 0.0),
                              torch.where(lower, want_s, 0.0)),
                "(xdt⊙decay)ᵀ·B": _ulps(h_out, want_h),
                "masked scores·xdt": _ulps(y, want_y),
                "C·hᵀ": _ulps(inter, want_inter)}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args(argv)
    report = probe()
    text = json.dumps(report, indent=1, ensure_ascii=False)
    print(text)
    if args.out:
        Path(args.out).write_text(text, encoding="utf-8")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

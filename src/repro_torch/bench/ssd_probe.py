"""What holds the SSD chunk-scan kernel back: edited copies of
``csrc/ssd.cu`` measured beside the shipped one on the same card.

    python -m repro_torch.bench.ssd_probe [--out FILE.json]

Each variant below is one named edit of the source, compiled with ``nvcc``
into a library of its own and launched through its ``extern "C"``
launcher on the same operands (the main path's shapes, ``SHAPES``):

- ``tensor_core_sums``: no fresh partial sums in the scores and states
  kernels: each of their products accumulates its whole k range in the
  tensor cores' own accumulator (which truncates), for the error that the
  partial sums avoid (the output kernel's partials are always one stage:
  its row halves share their registers);
- ``partials_k64``: the scores' and states' partial sums span two stages
  (k = 64, twice the shipped k = 32), for how long one may be;
- ``no_split``: operands reach the tensor cores unsplit (hi = x, lo = 0;
  wrong values; for the time the split costs, the producer's and the
  consumers');
- ``no_loads``: the stages after the ring's first fill are not copied
  (wrong values; for the time TMA costs);
- ``one_product``: only a_hi·b_hi of the three products runs (wrong
  values; for the time the tensor cores cost).

It prints, and writes as JSON with ``--out``: the card's sustained
``wgmma`` m64n64k8 TF32 rate, with long chains (4 accumulators, no wait)
and in the kernel's pattern (a group of twelve into one accumulator, then
a wait), two warpgroups a block; for each variant, the largest error of y
and of the final state in f32 ulps of the largest element (against the
plain version), each kernel's device time (``torch.profiler``) and the
whole launch's time (CUDA events); and, for the shipped kernel and
``tensor_core_sums``, the error of each product alone on one chunk. Runs
only on a card with ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import build
from ..kernels.ssd import KERNELS, ssd_chunk_scan_ref, tma_rows

#: the main path's (B, H, C, Q, P, N): mamba2-130m serving, zamba2-2.7b train
SHAPES = {"mamba2 serving": (4, 24, 128, 256, 64, 128),
          "zamba2 train": (1, 80, 32, 128, 64, 64)}

#: variant -> [(text of csrc/ssd.cu, its replacement)]
EDITS = {
    "shipped": [],
    "tensor_core_sums": [
        ("constexpr int kPartialStages = 1;",
         "constexpr int kPartialStages = 1 << 20;")],
    "partials_k64": [
        ("constexpr int kPartialStages = 1;",
         "constexpr int kPartialStages = 2;")],
    "no_split": [
        ("  split_tf32(x, hi, lo);\n}",
         "  hi = __float_as_uint(x);\n  lo = 0u;\n}")],
    "no_loads": [
        ("  const bool load = true;", "  const bool load = !c.wrapped;")],
    "one_product": [
        ("constexpr int kProducts = 3;", "constexpr int kProducts = 1;")],
}

_RATE_SRC = r"""
#include "tf32x3.cuh"
// 64 x 16 TF32 tiles of A and B (64-byte swizzle), two warpgroups a block.
// chain = 0: 4 accumulators, 8 wgmma a group, one group in flight;
// chain = 1: the kernel's pattern, 12 wgmma into one accumulator, then wait.
__global__ void __launch_bounds__(256) wgmma_rate(float* out, int iters,
                                                  int chain) {
  __shared__ __align__(1024) uint32_t tile[2][64 * 16];
  for (int i = threadIdx.x; i < 2 * 64 * 16; i += blockDim.x)
    tile[i / 1024][i % 1024] = __float_as_uint(1.0f / (1 + i % 7));
  __syncthreads();
  fence_async_smem();
  const uint64_t da = smem_desc<64>(smem_u32(tile[0]));
  const uint64_t db = smem_desc<64>(smem_u32(tile[1]));
  float acc[4][32];
  for (int c = 0; c < 4; ++c)
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
    if (chain) {
#pragma unroll
      for (int k = 0; k < 12; ++k)
        wgmma_ss<64>(acc[0], desc_add(da, 32 * (k % 2)),
                     desc_add(db, 32 * (k % 2)), k > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc[0]);
      for (int i = 0; i < 32; ++i) acc[1][i] += acc[0][i];
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          wgmma_ss<64>(acc[c], desc_add(da, 32 * k), desc_add(db, 32 * k), 1);
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait_all();
  float s = 0.0f;
  for (int c = 0; c < 4; ++c) {
    fence_regs(acc[c]);
    for (int i = 0; i < 32; ++i) s += acc[c][i];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_wgmma_rate(void* out, int blocks, int iters, int chain) {
  wgmma_rate<<<blocks, 256>>>(static_cast<float*>(out), iters, chain);
  return cudaGetLastError();
}
"""


def _compile(src: str, out: Path) -> ctypes.CDLL:
    cu = out.with_suffix(".cu")
    cu.write_text(src, encoding="utf-8")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-shared", "-o", str(out),
                           str(cu)], text=True, capture_output=True)
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
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 9
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(xdt, bm, cm, cum, h0=None):
        b, h, c, q, p = xdt.shape
        n = bm.shape[-1]
        y = torch.empty_like(xdt)
        h_out = xdt.new_empty((b, h, p, n))
        (xdt, ld_p), (bm, ld_n), (cm, _), (cum, ld_q) = map(
            tma_rows, (xdt, bm, cm, cum))
        scores = xdt.new_empty((b, c, q, ld_q))
        states = xdt.new_empty((b, h, c, p, ld_n))
        rc = fn(xdt.data_ptr(), bm.data_ptr(), cm.data_ptr(), cum.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(),
                h_out.data_ptr(), scores.data_ptr(), states.data_ptr(), b, h,
                c, q, p, n, ld_p, ld_n, ld_q, xdt.device.index,
                build.current_stream_ptr(xdt.device.index))
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return y, h_out, scores[..., :q]
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


def wgmma_rate(work: Path) -> dict:
    """Sustained wgmma m64n64k8 TF32 rate, TFLOP/s, two warpgroups a block
    and one block an SM per 256 threads: long chains (``chains``) and the
    kernel's pattern of a group of twelve, then a wait (``groups_of_12``), at
    1 and at 2 blocks an SM (2 and 4 warpgroups)."""
    lib = _compile(_RATE_SRC, work / "wgmma_rate.so")
    lib.run_wgmma_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for chain, label in ((0, "chains"), (1, "groups_of_12")):
        for per_sm in (1, 2):
            blocks, iters = sms * per_sm, 2048
            buf = torch.empty(blocks * 256, device="cuda")
            ms = _ms(lambda: lib.run_wgmma_rate(buf.data_ptr(), blocks,
                                                iters, chain), 3)
            mmas = blocks * 2 * iters * (12 if chain else 8)
            out[f"{label}_{2 * per_sm}wg"] = mmas * 2 * 64 * 64 * 8 / ms / 1e9
    return out


def probe() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the SSD probe runs on a card: "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(tempfile.mkdtemp(prefix="ssd_probe_"))
    report = {"device": torch.cuda.get_device_name(0),
              "wgmma_tf32": wgmma_rate(work), "variants": {}}
    with ThreadPoolExecutor(len(EDITS)) as pool:  # one nvcc a variant
        libs = dict(zip(EDITS, pool.map(
            lambda name: _compile(variant_source(name),
                                  work / f"ssd_{name}.so"), EDITS)))
    runs = {name: _launcher(lib) for name, lib in libs.items()}
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

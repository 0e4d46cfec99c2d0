"""What holds the f32 GEMM kernel back: edited copies of
``csrc/matmul_f32_sm90.cu`` measured beside the shipped one on the same
card.

    python -m repro_torch.bench.gemm_probe [--out FILE.json]

Each variant below is one named edit of the source, compiled with ``nvcc``
(``-Xptxas -v``) into a library of its own and launched through its
``extern "C"`` launchers on the same operands, at the tile search's
shape (``GEMM_MAIN``) and at every tile of ``TILES``, the variants in
turns tile by tile:

- ``no_loads``: the stages after the ring's first fill are not copied
  (wrong values; for the time TMA and the wait on it cost);
- ``no_fma``: the consumers read every operand and the barriers run, but
  nothing is multiplied (one XOR a word read keeps the reads; wrong
  values; for the time the shared-memory reads and barriers cost);
- ``tile_8x16``: an 8 x 16 register tile a consumer thread in place of 8
  x 8 (half the consumers, 0.75 bytes of shared memory a FMA in place of
  one, 128 accumulators a thread; the same values);
- ``a_reads_16B`` and ``a_reads_4B``: A read 4 or 1 k values at a time in
  place of 2;
- ``four_stages``: a ring of 4 stages in place of 3;
- ``lanes_8x4``: lane = ty + 8 tx (8 rows of lanes, 4 columns) in place
  of 4 ty + tx;
- ``budget_136``: 136 registers a consumer and 24 the producer, so that
  the launch bounds ask 3 blocks an SM of 128 x 64 and 64 x 128;
- ``first_build``: the design as first built, an 8 x 16 tile, A read 16
  bytes at a time, lane = ty + 8 tx.

It prints, and writes as JSON with ``--out``: for each variant and tile
the time (CUDA events), TFLOP/s, the largest difference from the shipped
kernel's C, and the kernel's threads, consumer threads, registers at
launch and a consumer's, spill bytes, dynamic shared memory, blocks an SM
and consumer warps a scheduler. Runs only on a card with ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import build
from ..kernels.matmul import TILES, tma_operand

#: the tile search's (m, n, k)
GEMM_MAIN = (4096, 2048, 6144)
SOURCE = "matmul_f32_sm90.cu"

_TILE_8X16 = ("constexpr int kTN = 8;  // register tile columns a consumer "
              "thread", "constexpr int kTN = 16;  // register tile columns a "
              "consumer thread")
_A_16B = ("constexpr int kAK = 2;", "constexpr int kAK = 4;")
_LANES_8X4 = [("const int ty = lane / 4;", "const int ty = lane % 8;"),
              ("const int tx = lane % 4;", "const int tx = lane / 8;")]
#: variant -> [(text of csrc/matmul_f32_sm90.cu, its replacement)]
EDITS = {
    "shipped": [],
    "no_loads": [
        ("        mbar_expect_tx(bar, L::kStageBytes);\n"
         "        tma_load_2d(dst, &maps.a, bar, t * BK, row0);\n"
         "        tma_load_2d(dst + L::kABytes, &maps.b, bar, col0, t * BK);\n",
         "        if (t >= kStages) {\n"
         "          mbar_arrive(bar);\n"
         "        } else {\n"
         "          mbar_expect_tx(bar, L::kStageBytes);\n"
         "          tma_load_2d(dst, &maps.a, bar, t * BK, row0);\n"
         "          tma_load_2d(dst + L::kABytes, &maps.b, bar, col0,"
         " t * BK);\n"
         "        }\n")],
    "no_fma": [
        ("            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);\n",
         "            if (j == 0 || i == 0)  // acc bits ^= a read word's\n"
         "              acc[i == 0][j == 0 ? i : j] = __int_as_float(\n"
         "                  __float_as_int(acc[i == 0][j == 0 ? i : j]) ^\n"
         "                  __float_as_int(j == 0 ? a[i][kk] : b[j]));\n")],
    "tile_8x16": [_TILE_8X16],
    "a_reads_16B": [_A_16B],
    "a_reads_4B": [("constexpr int kAK = 2;", "constexpr int kAK = 1;")],
    "four_stages": [("constexpr int kStages = 3;",
                     "constexpr int kStages = 4;")],
    "lanes_8x4": _LANES_8X4,
    "budget_136": [("constexpr int kConsumerBudget = 200;",
                    "constexpr int kConsumerBudget = 136;"),
                   ("constexpr int kProducerRegs = 40;",
                    "constexpr int kProducerRegs = 24;")],
    "first_build": [_TILE_8X16, _A_16B, *_LANES_8X4],
}

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5
             + [ctypes.c_int, ctypes.c_void_p])
_INFO = ("threads", "consumers", "smem_bytes", "registers",
         "consumer_registers", "blocks_per_sm", "min_blocks")


def variant_source(name: str) -> str:
    """``csrc/matmul_f32_sm90.cu`` with the variant's edits; raises if an
    edit no longer matches the source exactly once."""
    src = (build.CSRC / SOURCE).read_text(encoding="utf-8")
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: edit {old[:60]!r} matches "
                             f"{src.count(old)} places in {SOURCE}")
        src = src.replace(old, new)
    return src


def ptxas_rows(log: str) -> dict:
    """(bm, bn, bk) -> {"registers", "spill_stores", "spill_loads"} of each
    kernel instantiation in an ``-Xptxas -v`` log."""
    rows, tile = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*matmul_f32_sm90_kernel"
                      r"ILi(\d+)ELi(\d+)ELi(\d+)E", line)
        if m:
            tile = tuple(map(int, m.groups()))
            rows[tile] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if tile and m:
            rows[tile].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if tile and m:
            rows[tile]["registers"] = int(m.group(1))
            tile = None
    return rows


def _compile(name: str, work: Path) -> tuple[ctypes.CDLL, str]:
    cu = work / f"gemm_{name}.cu"
    so = work / f"gemm_{name}.so"
    cu.write_text(variant_source(name), encoding="utf-8")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-shared", "-o", str(so),
                           str(cu)], text=True, capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(so)), proc.stdout + proc.stderr


def _launcher(lib: ctypes.CDLL, tile):
    fn = getattr(lib, "rt_matmul_f32_sm90_{}x{}x{}".format(*tile))
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int

    def run(a, b):
        m, k = a.shape
        n = b.shape[1]
        a_, lda = tma_operand(a)
        b_, ldb = tma_operand(b)
        c = torch.empty((m, n), dtype=a.dtype, device=a.device)
        rc = fn(a_.data_ptr(), b_.data_ptr(), c.data_ptr(), m, n, k, lda,
                ldb, a.device.index,
                build.current_stream_ptr(a.device.index))
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return c
    return run


def _info(lib: ctypes.CDLL, tile) -> dict:
    out = (ctypes.c_int64 * len(_INFO))()
    rc = lib.rt_matmul_f32_sm90_info(*tile, out)
    if rc != 0:
        raise RuntimeError(f"info {tile}: CUDA error {rc}")
    info = dict(zip(_INFO, map(int, out)))
    info["consumer_warps_per_scheduler"] = (
        info["blocks_per_sm"] * info["consumers"] / 32 / 4)
    return info


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


def probe() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the GEMM probe runs on a card: "
                           "torch.cuda.is_available() is False")
    work = Path(tempfile.mkdtemp(prefix="gemm_probe_"))
    with ThreadPoolExecutor(len(EDITS)) as pool:  # one nvcc a variant
        built = dict(zip(EDITS, pool.map(lambda v: _compile(v, work),
                                         EDITS)))
    m, n, k = GEMM_MAIN
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(m, k, generator=gen).cuda()
    b = torch.randn(k, n, generator=gen).cuda()
    flops = 2.0 * m * n * k
    report = {"device": torch.cuda.get_device_name(0),
              "shape": list(GEMM_MAIN), "variants": {}}
    regs = {name: ptxas_rows(log) for name, (_, log) in built.items()}
    for tile in TILES:  # the variants in turns, tile by tile
        runs = {name: _launcher(lib, tile) for name, (lib, _) in built.items()}
        shipped = runs["shipped"](a, b)
        for name, run in runs.items():
            c = run(a, b)
            ms = _ms(lambda: run(a, b))
            report["variants"].setdefault(name, {})[
                "x".join(map(str, tile))] = {
                "ms": ms, "tflops": flops / ms / 1e9,
                "max_abs_diff_shipped": float((c - shipped).abs().max()),
                **_info(built[name][0], tile), **regs[name].get(tile, {})}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args(argv)
    report = probe()
    for name, rows in report["variants"].items():
        for tile, row in rows.items():
            print(f"{name:9s} {tile:10s} {row['ms']:.4f} ms "
                  f"{row['tflops']:.2f} TFLOP/s diff "
                  f"{row['max_abs_diff_shipped']:.3g} | "
                  f"{row['threads']} threads ({row['consumers']} consumers), "
                  f"{row.get('registers', '?')} registers "
                  f"({row['consumer_registers']} a consumer), spills "
                  f"{row.get('spill_stores', '?')}/"
                  f"{row.get('spill_loads', '?')} bytes, "
                  f"{row['smem_bytes']} bytes shared, "
                  f"{row['blocks_per_sm']} blocks an SM, "
                  f"{row['consumer_warps_per_scheduler']:g} consumer warps "
                  f"a scheduler")
    text = json.dumps(report, indent=1)
    if args.out:
        Path(args.out).write_text(text, encoding="utf-8")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

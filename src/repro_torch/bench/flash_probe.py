"""What holds the f32 (3xTF32) flash-attention kernels back: edited copies
of ``csrc/flash_attention_tf32x3.cu`` (head dim 64) or of
``csrc/flash_attention_tf32x3_d256.cu`` (head dim 256) measured beside the
shipped one on the same card.

    python -m repro_torch.bench.flash_probe [--head-dim 64|256] [--out FILE.json]

At head dim 64 (the default), each variant of EDITS is one named edit of
the source, compiled with ``nvcc`` at head dim 64 into a library of its
own and launched through its ``extern "C"`` launchers on the same
operands (FLASH_MAIN: B=1, H=32, Hkv=8, S=4096, D=64, causal), at both
physical tiles:

- ``truncated_hi``: hi is each operand truncated to TF32 (what the tensor
  cores read from a raw f32 tile) in place of rounded, for the error;
- ``tensor_core_pv``: P·V accumulates across the kv tiles in the tensor
  cores' own accumulator (which truncates), for the error that the fresh
  accumulator of each tile avoids;
- ``two_producers``: two producer warpgroups split K and V, for the time;
- ``rolled_producer``: the producer's loops are not unrolled, for the
  time its loads in flight save;
- ``no_pingpong``: the two consumer warpgroups do not take turns at the
  tensor cores, for the time the turns save;
- ``no_split``: the producer splits nothing (wrong values; for the time
  the split costs);
- ``one_product``: only a_hi·b_hi of the three products runs, in both
  products (wrong values; for the time the tensor cores cost).

At head dim 256 (gemma-2b's widths: B=1, H=8, Hkv=1, S=4096, causal) the
variants of EDITS_D256 are edits of the D = 256 kernel, each timed at
both of its tiles: (64, 32), one consumer warpgroup and no turns (design
(a)), against (128, 16), two consumers taking turns at the tensor cores
(design (b)); ``shipped`` (no edit), ``one_product`` and ``no_split`` as
above; ``q_buffers_<n>``: Q's fragments through n register buffers, n
wgmma groups of S in flight, not two; ``divergent_role``: the
warpgroup index not broadcast from lane 0, so ptxas cannot see it warp-
uniform and serialises the wgmmas (its C7520 note). The CUDA-core kernel
it replaced (``csrc/flash_attention.cu``) is timed beside them
(``was_ms``).

It prints, and writes as JSON with ``--out``: the card's name and power
limit (``nvidia-smi``); for each variant and tile,
the time (CUDA events) and the largest error against the plain version,
on f32 operands and on f32 copies of bf16 operands (whose lo parts are
zero, as chip_smoke.py's main-shape check has them). Runs only on a card
with ``nvcc``.
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
from ..kernels.flash_attention import attention_ref, flops
from ..kernels.flash_attention.ops import _ARGTYPES

#: (B, H, Hkv, S, D): granite-3-2b's attention at the train step's length
SHAPE = (1, 32, 8, 4096, 64)
#: the physical tiles compiled for head dim 64, (q rows, kv rows)
TILES = ((64, 64), (128, 64))
#: f32-accurate products from the TF32 tensor cores: 495 / 3 TFLOP/s
TF32X3_PEAK = 495e12 / 3
#: gemma-2b's widths (B, H, Hkv, S, D) and the D = 256 kernel's tiles:
#: design (a) (64, 32), one consumer; design (b) (128, 16), two in turns
SHAPE_D256 = (1, 8, 1, 4096, 256)
TILES_D256 = ((64, 32), (128, 16))
_TABLE_D256 = ("#define RT_FLASH_TF32X3_D256_TILES(X) X(256, 64, 32) "
               "X(256, 128, 16)\n\n")

_TABLE_64 = ("#define RT_FLASH_TF32X3_TILES(X) \\\n"
             "  X(64, 64, 64) X(64, 128, 64)\n\n")

#: variant -> [(text of the source, its replacement)], each replaced
#: wherever it occurs
EDITS = {
    "shipped": [],
    "truncated_hi": [
        ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
         "  hi = __float_as_uint(x) & 0xffffe000u;")],
    "tensor_core_pv": [
        ("    float o_tile[D / 2];\n",
         "    float (&o_tile)[D / 2] = o_acc;\n"
         "#pragma unroll\n"
         "    for (int j = 0; j < D / 8; ++j) {\n"
         "      o_acc[4 * j] *= alpha.x;\n"
         "      o_acc[4 * j + 1] *= alpha.x;\n"
         "      o_acc[4 * j + 2] *= alpha.y;\n"
         "      o_acc[4 * j + 3] *= alpha.y;\n"
         "    }\n"),
        ("desc_add(v_desc[part == 1], vo), part > 0 || kk > 0);",
         "desc_add(v_desc[part == 1], vo), 1);"),
        ("      o_acc[4 * j] = fmaf(o_acc[4 * j], alpha.x, o_tile[4 * j]);\n"
         "      o_acc[4 * j + 1] = fmaf(o_acc[4 * j + 1], alpha.x, "
         "o_tile[4 * j + 1]);\n"
         "      o_acc[4 * j + 2] = fmaf(o_acc[4 * j + 2], alpha.y, "
         "o_tile[4 * j + 2]);\n"
         "      o_acc[4 * j + 3] = fmaf(o_acc[4 * j + 3], alpha.y, "
         "o_tile[4 * j + 3]);\n", "")],
    "two_producers": [
        ("  static constexpr int kProducers = 1;",
         "  static constexpr int kProducers = 2;")],
    "rolled_producer": [
        ("#pragma unroll\n      for (int it = 0; it < KT * D / 4 / "
         "L::kProducerThreads; ++it) {",
         "#pragma unroll 1\n      for (int it = 0; it < KT * D / 4 / "
         "L::kProducerThreads; ++it) {")],
    "no_pingpong": [
        ("constexpr bool kPingPong = L::kConsumers > 1;",
         "constexpr bool kPingPong = false;")],
    "no_split": [
        ("for (int it = 0; it < KT * D / 4 / L::kProducerThreads; ++it) {",
         "for (int it = 0; it < 0; ++it) {")],
    "one_product": [
        ("    for (int part = 0; part < 3; ++part)",
         "    for (int part = 2; part < 3; ++part)"),
        ("part > 0 || kk > 0);", "kk > 0);")],
}


#: the D = 256 kernel's variants, as EDITS
EDITS_D256 = {
    "shipped": [],
    "one_product": [
        ("constexpr int kFirstStep = 0;", "constexpr int kFirstStep = kSteps;"),
        ("constexpr int kFirstPart = 0;", "constexpr int kFirstPart = 2;")],
    "no_split": [
        ("static constexpr int kProducerIters = KT * kD / 4 / "
         "kProducerThreads;", "static constexpr int kProducerIters = 0;")],
    "divergent_role": [
        ("const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);",
         "const int wg = tid / 128;")],
    **{f"q_buffers_{n}": [("constexpr int kQBufs = 2;",
                           f"constexpr int kQBufs = {n};")]
       for n in (4, 6, 8)},
}


def variant_source(name: str, head_dim: int = 64) -> str:
    """The kernel source of ``head_dim`` with ``csrc/tf32x3.cuh`` inlined
    and the variant's edits: at 64, ``csrc/flash_attention_tf32x3.cu`` cut
    to head dim 64 (EDITS); at 256, ``csrc/flash_attention_tf32x3_d256.cu``
    with both designs' tiles (EDITS_D256). Raises if an edit no longer
    matches the source."""
    source, edits, macro, table = (
        ("flash_attention_tf32x3_d256.cu", EDITS_D256,
         "#define RT_FLASH_TF32X3_D256_TILES(X)", _TABLE_D256)
        if head_dim == 256 else
        ("flash_attention_tf32x3.cu", EDITS,
         "#define RT_FLASH_TF32X3_TILES(X)", _TABLE_64))
    src = (build.CSRC / source).read_text(encoding="utf-8")
    start = src.index(macro)
    src = src[:start] + table + src[src.index("\n\n", start) + 2:]
    # the shared header inline, so that an edit may reach its helpers
    header = (build.CSRC / "tf32x3.cuh").read_text(encoding="utf-8")
    src = src.replace('#include "tf32x3.cuh"\n',
                      header.replace("#pragma once\n", ""))
    for old, new in edits[name]:
        if old not in src:
            raise ValueError(f"variant {name}: edit {old[:60]!r} matches "
                             f"nothing in {source}")
        src = src.replace(old, new)
    return src


def _compile(name: str, work: Path, head_dim: int) -> subprocess.Popen:
    cu = work / f"flash_{name}.cu"
    cu.write_text(variant_source(name, head_dim), encoding="utf-8")
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I",
         str(build.CSRC), "-shared", "-o", str(cu.with_suffix(".so")),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _launcher(lib: ctypes.CDLL, name: str, bq: int, bk: int):
    """The causal launch of ``lib``'s launcher ``name`` at the logical
    block (bq, bk), on (q, k, v, o)."""
    fn = getattr(lib, name)
    fn.argtypes = list(_ARGTYPES)
    fn.restype = ctypes.c_int

    def run(q, k, v, o):
        b, h, s, d = q.shape
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
                k.shape[1], s, s, bq, bk, 1, 0, d ** -0.5, q.device.index,
                build.current_stream_ptr(q.device.index))
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return run


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _compile_was(work: Path) -> subprocess.Popen:
    """The CUDA-core kernel of ``csrc/flash_attention.cu``, the design the
    D = 256 kernel replaced, into a library of its own."""
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
         str(work / "flash_was.so"),
         str(build.CSRC / "flash_attention.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def probe(head_dim: int = 64) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the flash probe runs on a card: "
                           "torch.cuda.is_available() is False")
    edits, shape, tiles = ((EDITS_D256, SHAPE_D256, TILES_D256)
                           if head_dim == 256 else (EDITS, SHAPE, TILES))
    work = Path(tempfile.mkdtemp(prefix="flash_probe_"))
    procs = {name: _compile(name, work, head_dim) for name in edits}
    if head_dim == 256:
        procs["was"] = _compile_was(work)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(work / f"flash_{name}.so"))
    b, h, hkv, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    f32 = [torch.randn(b, n, s, d, generator=gen, device="cuda")
           for n in (h, hkv, hkv)]
    from_bf16 = [x.bfloat16().float() for x in f32]
    wants = {"f32": attention_ref(*f32, causal=True),
             "bf16_copies": attention_ref(*from_bf16, causal=True)}
    o = torch.empty_like(f32[0])
    work_flops = flops(b, h, s, d, True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    report = {"device": torch.cuda.get_device_name(0),
              "card": card[0] if card else "not reported",
              "shape": list(shape),
              "bound_ms": work_flops / TF32X3_PEAK * 1e3, "variants": {}}
    if "was" in libs:   # the replaced design, at the quick space's (64, 64)
        run = _launcher(libs.pop("was"), f"rt_flash_attention_f32_d{d}",
                        64, 64)
        report["was_ms"] = _ms(lambda: run(*f32, o), iters=3)
        report["was_max_abs_err_f32"] = float((o - wants["f32"]).abs().max())
    for name, lib in libs.items():
        for qt, kt in tiles:
            run = _launcher(lib, f"rt_flash_attention_tf32x3_d{d}_q{qt}_k{kt}",
                            qt, kt)
            row = {}
            for label, ops in (("f32", f32), ("bf16_copies", from_bf16)):
                run(*ops, o)
                torch.cuda.synchronize()
                row[f"max_abs_err_{label}"] = float(
                    (o - wants[label]).abs().max())
            row["ms"] = _ms(lambda: run(*f32, o))
            report["variants"].setdefault(name, {})[f"{qt}x{kt}"] = row
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--head-dim", type=int, choices=(64, 256), default=64,
                    help="the kernel to probe: the 3xTF32 one at 64, its "
                         "D = 256 kernel at 256 (default 64)")
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args(argv)
    report = probe(args.head_dim)
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text, encoding="utf-8")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

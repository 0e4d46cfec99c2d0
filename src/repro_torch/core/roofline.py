"""Roofline model assembly (paper Sec. II, Eq. 1-2).

    I = W / Q                      (operational intensity, FLOP/byte)
    F_a(I) = min(B_a * I, F_p)     (attainable performance)

The paper's tool emits this model from *measured* peaks (autotuned DGEMM for
F_p, autotuned TRIAD for each memory subsystem's B_a) with no vendor specs.
We keep that shape, and additionally ship the H100 SXM's published peaks
(:data:`H100_SXM`) as the theoretical machine a measured model is held
against.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Peak terms for one machine (theoretical or measured)."""

    name: str
    peak_flops: float                      # FLOP/s (per card)
    mem_bandwidths: Mapping[str, float]    # subsystem name -> bytes/s
    link_bandwidth: float = 0.0            # bytes/s per direction per link
    chips: int = 1

    @property
    def total_flops(self) -> float:
        return self.peak_flops * self.chips

    def total_bandwidth(self, subsystem: str) -> float:
        return self.mem_bandwidths[subsystem] * self.chips


# NVIDIA H100 SXM, per card: published data-sheet figures at the full
# 700 W power limit (dense, no sparsity), not measurements. A card set to a
# lower power limit runs below them under load.
H100_SXM = MachineSpec(
    name="h100-sxm",
    peak_flops=67e12,                      # f32 on CUDA cores (the DGEMM's)
    mem_bandwidths={"hbm": 3.35e12},
    link_bandwidth=450e9,                  # NVLink, each way
)

#: H100 SXM dense bf16 tensor-core peak (data sheet, 700 W).
H100_SXM_BF16_FLOPS = 989e12


def attainable(intensity: float, peak_flops: float, bandwidth: float) -> float:
    """F(I) = min(B*I, Fp) — paper Eq. 2."""
    return min(bandwidth * intensity, peak_flops)


def ridge_point(peak_flops: float, bandwidth: float) -> float:
    """Intensity at which the roof flattens: I* = Fp / B."""
    return peak_flops / bandwidth


@dataclasses.dataclass(frozen=True)
class RooflineModel:
    """A machine's roofline: one compute ceiling, N bandwidth slopes."""

    machine: MachineSpec

    def attainable(self, intensity: float, subsystem: str) -> float:
        return attainable(intensity, self.machine.total_flops,
                          self.machine.total_bandwidth(subsystem))

    def bound(self, intensity: float, subsystem: str) -> str:
        ridge = ridge_point(self.machine.total_flops,
                            self.machine.total_bandwidth(subsystem))
        return "compute" if intensity >= ridge else "memory"

    def percent_of_roof(self, intensity: float, achieved_flops: float,
                        subsystem: str) -> float:
        """Measured performance as a percentage of the attainable roof at
        this intensity — the model-vs-measured gap the dashboards report."""
        roof = self.attainable(intensity, subsystem)
        if roof <= 0:
            return 0.0
        return 100.0 * achieved_flops / roof

    def gap_table(self, marks: Sequence[tuple[str, float, float]],
                  ) -> list[dict]:
        """Model-vs-measured rows for achieved-kernel markers: one row per
        (marker, memory subsystem) with the attainable roof at the
        marker's intensity, the %-of-roof gap, and the bound class."""
        rows = []
        for label, mi, mf in marks:
            for sub in self.machine.mem_bandwidths:
                rows.append({
                    "kernel": label,
                    "subsystem": sub,
                    "intensity_flop_per_byte": mi,
                    "achieved_flops": mf,
                    "attainable_flops": self.attainable(mi, sub),
                    "pct_of_roof": self.percent_of_roof(mi, mf, sub),
                    "bound": self.bound(mi, sub),
                })
        return rows

    # -- emission --------------------------------------------------------------
    def curve(self, subsystem: str, i_lo: float = 2 ** -6, i_hi: float = 2 ** 12,
              points_per_decade: int = 8) -> list[tuple[float, float]]:
        """Log-spaced (I, F(I)) samples for plotting/CSV."""
        out = []
        lo, hi = math.log2(i_lo), math.log2(i_hi)
        n = max(2, int((hi - lo) * points_per_decade / math.log2(10)))
        for k in range(n + 1):
            i = 2.0 ** (lo + (hi - lo) * k / n)
            out.append((i, self.attainable(i, subsystem)))
        return out

    def to_csv(self) -> str:
        rows = ["subsystem,intensity_flop_per_byte,attainable_flops"]
        for sub in self.machine.mem_bandwidths:
            for i, f in self.curve(sub):
                rows.append(f"{sub},{i:.6g},{f:.6g}")
        return "\n".join(rows)

    @staticmethod
    def _raster(series: Sequence[tuple[str, Sequence[tuple[float, float]]]],
                point_marks: Sequence[tuple[str, float, float]],
                width: int, height: int) -> list[str]:
        """Shared log-log rasterizer: draw each (char, curve) series then
        each (char, I, F) marker onto one grid, returning the bordered
        rows. Axes scale to the union of everything drawn."""
        xs = [math.log2(i) for _, pts in series for i, _ in pts]
        ys = [math.log2(max(f, 1.0)) for _, pts in series for _, f in pts]
        xs += [math.log2(i) for _, i, _ in point_marks]
        ys += [math.log2(max(f, 1.0)) for _, _, f in point_marks]
        x0, x1 = min(xs), max(xs)
        y0, y1 = min(ys), max(ys)
        grid = [[" "] * width for _ in range(height)]

        def put(x: float, y: float, ch: str):
            cx = int((x - x0) / max(x1 - x0, 1e-9) * (width - 1))
            cy = int((y - y0) / max(y1 - y0, 1e-9) * (height - 1))
            grid[height - 1 - cy][cx] = ch

        for ch, pts in series:
            for i, f in pts:
                put(math.log2(i), math.log2(max(f, 1.0)), ch)
        for ch, mi, mf in point_marks:
            put(math.log2(mi), math.log2(max(mf, 1.0)), ch)
        return ["|" + "".join(r) + "|" for r in grid]

    def ascii_plot(self, subsystem: str, width: int = 64, height: int = 16,
                   marks: Sequence[tuple[str, float, float]] = ()) -> str:
        """Log-log ASCII roofline of one subsystem with optional
        (label, I, F) markers (drawn as the label's first letter)."""
        rows = self._raster([("*", self.curve(subsystem))],
                            [(label[0].upper(), mi, mf)
                             for label, mi, mf in marks], width, height)
        header = (f"roofline[{self.machine.name}/{subsystem}] "
                  f"x=log2(I), y=log2(FLOP/s)")
        return "\n".join([header] + rows)

    _CURVE_CHARS = "*+x#o@"

    @staticmethod
    def _mark_chars(labels: Sequence[str]) -> list[str]:
        """One distinct uppercase character per mark: the first unused
        alphanumeric of the label, falling back to any unused letter/digit
        (two 'triad:*' marks must not both render as 'T')."""
        used: set[str] = set()
        out = []
        for label in labels:
            candidates = [c for c in label.upper() if c.isalnum()]
            candidates += list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")
            ch = next((c for c in candidates if c not in used), "?")
            used.add(ch)
            out.append(ch)
        return out

    def dashboard(self, marks: Sequence[tuple[str, float, float]] = (),
                  width: int = 64, height: int = 16) -> str:
        """Every memory subsystem's roof on one log-log ASCII grid, with
        achieved-kernel markers drawn on top (each marker gets its own
        character, derived from its label)."""
        series = [(self._CURVE_CHARS[k % len(self._CURVE_CHARS)],
                   self.curve(sub))
                  for k, sub in enumerate(self.machine.mem_bandwidths)]
        mark_chars = self._mark_chars([label for label, _, _ in marks])
        point_marks = [(ch, mi, mf)
                       for (_, mi, mf), ch in zip(marks, mark_chars)]
        legend = [f"{ch}={sub}" for (ch, _), sub
                  in zip(series, self.machine.mem_bandwidths)]
        legend += [f"{ch}={label}"
                   for (label, _, _), ch in zip(marks, mark_chars)]
        header = (f"roofline[{self.machine.name}] "
                  f"x=log2(I), y=log2(FLOP/s)")
        lines = ([header]
                 + self._raster(series, point_marks, width, height)
                 + ["legend: " + "  ".join(legend)])
        return "\n".join(lines)


def from_measurements(name: str, measured_peak_flops: float,
                      measured_bandwidths: Mapping[str, float],
                      chips: int = 1) -> RooflineModel:
    """Assemble the empirical model from the tuner's benchmark outputs —
    the paper's end product."""
    return RooflineModel(MachineSpec(
        name=name, peak_flops=measured_peak_flops,
        mem_bandwidths=dict(measured_bandwidths), chips=chips))


def operational_intensity(flops: float, bytes_moved: float) -> float:
    """I = W / Q — paper Eq. 1."""
    if bytes_moved <= 0:
        return math.inf
    return flops / bytes_moved


TRIAD_INTENSITY = 2.0 / 24.0  # paper Sec. III-B: 2 FLOP per 24 bytes = 1/12

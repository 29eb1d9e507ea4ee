"""Structured per-step metrics and image-quality metrics -- the port's own
copy of ``neuralradiancecaching_tpu/utils/metrics.py`` (numpy only), kept
equal to it so the port imports nothing of the JAX package: a JSONL metrics
logger, RMSE / relative RMSE / PSNR, and the twin-pair noise-subtracted
bias estimator with its +-2 sigma interval (the bench's ground-truth
protocol, used by ``chip_smoke.py``'s quality legs).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import IO

import numpy as np


class MetricsLogger:
    """Append-only JSONL metrics log with wall-clock timestamps."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._fh: IO | None = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                        exist_ok=True)
            self._fh = open(path, "a")
        self.t0 = time.perf_counter()
        self.rows = []

    def log(self, step: int, **values) -> dict:
        row = {"step": step, "t": round(time.perf_counter() - self.t0, 4),
               **{k: (float(v) if hasattr(v, "__float__") else v)
                  for k, v in values.items()}}
        self.rows.append(row)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        return row

    def write_csv(self, path: str) -> None:
        if not self.rows:
            return
        keys = sorted({k for r in self.rows for k in r})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.rows)

    def close(self) -> None:
        if self._fh:
            self._fh.close()


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def relative_rmse(a: np.ndarray, ref: np.ndarray) -> float:
    """RMSE normalized by the reference's RMS -- the '<=1% RMSE vs converged
    no-cache' metric of BASELINE.json."""
    ref = np.asarray(ref, np.float64)
    denom = np.sqrt(np.mean(ref ** 2)) + 1e-12
    return rmse(a, ref) / denom


def psnr(a: np.ndarray, ref: np.ndarray, peak: float | None = None) -> float:
    ref = np.asarray(ref, np.float64)
    if peak is None:
        peak = max(float(ref.max()), 1.0)
    mse = np.mean((np.asarray(a, np.float64) - ref) ** 2)
    return float(10.0 * np.log10(peak * peak / max(mse, 1e-12)))


def noise_subtracted_bias(a1: np.ndarray, a2: np.ndarray,
                          r1: np.ndarray, r2: np.ndarray
                          ) -> tuple[float, float]:
    """Twin-pair noise-floor-subtracted relative RMSE between estimator A
    and reference estimator R (the bench's north-star quality protocol,
    VERDICT r2 item 5).

    a1/a2 and r1/r2 are independent same-settings renders (disjoint RNG).
    For Abar = (a1+a2)/2 etc.,

        E mean((Abar - Rbar)^2) = bias^2 + (s_A^2 + s_R^2)/2

    with the per-image variances s^2 estimated from the twins
    (E mean((x1-x2)^2) = 2 s^2), so the subtraction estimates bias^2
    unbiasedly; averaging over all pixels makes the estimator noise
    negligible. Returns (bias_rel, floor_rel), both relative to
    rms(Rbar).
    """
    a1, a2 = np.asarray(a1, np.float64), np.asarray(a2, np.float64)
    r1, r2 = np.asarray(r1, np.float64), np.asarray(r2, np.float64)
    var_a = float(np.mean((a1 - a2) ** 2)) / 2
    var_r = float(np.mean((r1 - r2) ** 2)) / 2
    a_bar, r_bar = (a1 + a2) / 2, (r1 + r2) / 2
    ms = float(np.mean((a_bar - r_bar) ** 2))
    floor_ms = (var_a + var_r) / 2
    rms = max(float(np.sqrt(np.mean(r_bar ** 2))), 1e-12)
    bias_rel = float(np.sqrt(max(ms - floor_ms, 0.0))) / rms
    floor_rel = float(np.sqrt(floor_ms)) / rms
    return bias_rel, floor_rel


def noise_subtracted_bias_err(a1: np.ndarray, a2: np.ndarray,
                              r1: np.ndarray, r2: np.ndarray
                              ) -> tuple[float, float, float, float]:
    """:func:`noise_subtracted_bias` with a measured uncertainty on the
    bias estimate (VERDICT r4 item 1b: the <=1% north-star claim must hold
    at +-2 sigma, not flip sign with run-to-run noise).

    The bias^2 estimator is a mean over pixels of the per-pixel statistic
        z_i = dbar_i^2 - ((a1-a2)_i^2 + (r1-r2)_i^2) / 4,
    whose expectation is bias_i^2 (the twin terms subtract the MC noise
    floor unbiasedly). Pixels carry independent MC noise (per-ray RNG
    streams), so the standard error of mean(z) is std(z)/sqrt(N_pixels);
    channels within a pixel are correlated (shared path), so z is reduced
    over channels FIRST and N counts pixels, not elements.

    Returns (bias_rel, floor_rel, bias_rel_lo2s, bias_rel_hi2s): the point
    estimate, the noise floor, and the +-2 sigma interval of the bias --
    all relative to rms(Rbar). bias_rel_hi2s <= tolerance is the
    statistically safe form of a "bias <= tolerance" claim.
    """
    a1, a2 = np.asarray(a1, np.float64), np.asarray(a2, np.float64)
    r1, r2 = np.asarray(r1, np.float64), np.asarray(r2, np.float64)
    a_bar, r_bar = (a1 + a2) / 2, (r1 + r2) / 2
    d = a_bar - r_bar
    z = d ** 2 - ((a1 - a2) ** 2 + (r1 - r2) ** 2) / 4
    zp = z.reshape(-1, z.shape[-1]).mean(axis=1) if z.ndim >= 2 else z
    m = float(zp.mean())
    sem = float(zp.std(ddof=1)) / np.sqrt(zp.shape[0])
    floor_ms = float(np.mean((a1 - a2) ** 2 + (r1 - r2) ** 2)) / 4
    rms = max(float(np.sqrt(np.mean(r_bar ** 2))), 1e-12)
    bias_rel = float(np.sqrt(max(m, 0.0))) / rms
    lo = float(np.sqrt(max(m - 2 * sem, 0.0))) / rms
    hi = float(np.sqrt(max(m + 2 * sem, 0.0))) / rms
    floor_rel = float(np.sqrt(floor_ms)) / rms
    return bias_rel, floor_rel, lo, hi

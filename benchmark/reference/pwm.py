"""The benchmark's MatInspector (PWM) scores for STEP 4's branch-point
sweep: the two branch-point matrices transcribed from the reference
(src/classify-intron.c, a frozen copy of the port's
``factorize/pwm_data.py`` tables), their per-column consensus (CV) and
maximum vectors worked out again here, and the window scores

    (sum_l cv_l * pwm[base_l, l]) / (sum_l cv_l * max_l)

(classify-intron.c:620-663) in float64, a code outside 0..3 adding
nothing.  ``scores_bf16`` computes the same in bfloat16: the control,
one step of precision below the float32 the port scores in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PWM = {
    "BPS_9": [  # 12 columns
        [0.16, 0.19, 0.08, 0.09, 0.01, 0.01, 0.01, 0.01, 1.00, 0.94, 0.01, 0.28],
        [0.15, 0.18, 0.12, 0.09, 0.90, 0.90, 0.01, 0.01, 0.00, 0.01, 0.84, 0.16],
        [0.18, 0.14, 0.13, 0.07, 0.01, 0.01, 0.01, 0.01, 0.00, 0.04, 0.01, 0.04],
        [0.51, 0.49, 0.67, 0.75, 0.08, 0.08, 0.97, 0.97, 0.00, 0.01, 0.14, 0.52],
    ],
    "BPS_10": [  # 12 columns
        [0.12, 0.12, 0.13, 0.09, 0.01, 0.01, 0.01, 0.01, 0.70, 1.00, 0.02, 0.23],
        [0.15, 0.17, 0.20, 0.10, 0.86, 0.92, 0.03, 0.01, 0.02, 0.00, 0.82, 0.25],
        [0.21, 0.18, 0.12, 0.05, 0.01, 0.01, 0.01, 0.03, 0.24, 0.00, 0.02, 0.05],
        [0.52, 0.53, 0.55, 0.76, 0.12, 0.06, 0.95, 0.95, 0.04, 0.00, 0.14, 0.47],
    ],
}

# the reference adds a float-literal pseudocount to every entry
# (classify-intron.c, "+0.00001f"); 0.00001f rounds to this double
PSEUDOCOUNT = 9.9999997473787516e-06


def _tables():
    out = {}
    for name, rows in PWM.items():
        m = np.asarray(rows, dtype=np.float64) + PSEUDOCOUNT
        cv = (m * np.log(m)).sum(axis=0) + math.log(5.0)
        cv *= 100.0 / math.log(5.0)
        maxv = m.max(axis=0)
        out[name] = (m, cv, maxv)
    return out


TABLES = _tables()


def identify(wpwm: np.ndarray, den: float):
    """The matrix a batch was scored against: the name whose float32
    cv-weighted table and denominator, worked out here, equal the
    batch's bit for bit; None when none does."""
    for name, (m, cv, maxv) in TABLES.items():
        w32 = m.astype(np.float32) * cv.astype(np.float32)[None, :]
        d32 = float(np.dot(cv.astype(np.float32), maxv.astype(np.float32)))
        if (w32.shape == wpwm.shape and np.array_equal(w32, wpwm)
                and d32 == float(den)):
            return name
    return None


def scores64(rows: np.ndarray, name: str) -> np.ndarray:
    """(B, L) int8 window codes -> (B,) float64 scores."""
    m, cv, maxv = TABLES[name]
    w = np.concatenate([m * cv[None, :], np.zeros((1, m.shape[1]))])
    codes = rows.astype(np.int64)
    codes = np.where((codes >= 0) & (codes < 4), codes, 4)
    num = w[codes, np.arange(rows.shape[1])[None, :]].sum(axis=1)
    return num / float(np.dot(cv, maxv))


def scores_bf16(rows: np.ndarray, name: str) -> np.ndarray:
    """The control: the same scores with the weights, the sum and the
    division in bfloat16; (B,) float32."""
    m, cv, maxv = TABLES[name]
    bf = torch.bfloat16
    w = torch.cat([torch.from_numpy(m * cv[None, :]).to(bf),
                   torch.zeros((1, m.shape[1]), dtype=bf)])
    codes = torch.from_numpy(rows.astype(np.int64))
    codes = torch.where((codes >= 0) & (codes < 4), codes,
                        torch.full_like(codes, 4))
    acc = torch.zeros(rows.shape[0], dtype=bf)
    for col in range(rows.shape[1]):
        acc = acc + w[:, col][codes[:, col]]
    den = torch.tensor(float(np.dot(cv, maxv)), dtype=bf)
    return (acc / den).to(torch.float32).numpy()

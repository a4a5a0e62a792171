"""Records what the program's device families answered during the
window, for the check in ``benchmark/reference/check.py``.

``Recorder.install()`` wraps the port's bounded offload entries
(``ops.offload.eval_kband``, ``eval_nw``, ``eval_gap``, ``eval_rb``,
``eval_edit_batch`` and ``pwm_scores_batched``), which STEPs 2 and 4
call through the module, so the wrappers see every batch as the
pipeline gets it back: from the kernels in this process, or from the
device service.  Once ``armed``, each batch leaves a sample drawn from
the seed (its largest problem and a few others; a few hundred of a PWM
batch's windows) in a file of this process's own under the run's
directory: STEP 2's fork workers inherit the wrappers and write their
own files.  The check reads them all after the window.
"""

from __future__ import annotations

import glob
import os
import pickle
import random
import zlib

import numpy as np

# problems sampled from each batch besides its largest, and PWM windows
SAMPLE = {"kband": 3, "nw": 1, "gap": 1, "rb": 1, "edit": 2}
PWM_SAMPLE = 256
ENTRIES = {"kband": "eval_kband", "nw": "eval_nw", "gap": "eval_gap",
           "rb": "eval_rb", "edit": "eval_edit_batch",
           "pwm": "pwm_scores_batched"}


class Recorder:
    def __init__(self, directory: str, seed: int):
        self.dir = directory
        self.seed = seed
        self.armed = False
        self.originals = {}
        os.makedirs(directory, exist_ok=True)

    def _rng(self, family: str, n: int, first: bytes) -> random.Random:
        return random.Random(f"{self.seed}:{family}:{n}:{zlib.crc32(first)}")

    def _pick(self, family: str, problems) -> list:
        n = len(problems)
        if n == 0:
            return []
        largest = max(range(n), key=lambda i: len(problems[i][0])
                      * len(problems[i][1]))
        rng = self._rng(family, n, problems[0][0])
        return sorted({largest, *rng.sample(range(n),
                                            min(n, SAMPLE[family]))})

    def _save(self, recs: list) -> None:
        if recs:
            path = os.path.join(self.dir, f"{os.getpid()}.pkl")
            with open(path, "ab") as f:
                pickle.dump(recs, f, protocol=pickle.HIGHEST_PROTOCOL)

    def _record(self, family: str, args, res) -> None:
        if family == "pwm":
            rows, wpwm, den = args
            n = rows.shape[0]
            if n == 0:
                return
            rng = self._rng(family, n, rows[0].tobytes())
            idx = np.array(sorted(rng.sample(range(n), min(n, PWM_SAMPLE))))
            self._save([("pwm", (rows[idx].copy(), np.array(wpwm), den),
                         np.asarray(res)[idx].copy())])
            return
        problems = args[0]
        recs = []
        for i in self._pick(family, problems):
            if family in ("kband", "edit"):
                ans = int(res[i])
            elif family == "nw":
                ops, n, evaluated = res
                if not evaluated[i]:
                    continue
                ans = (np.asarray(ops[i, :int(n[i])], dtype=np.int8)
                       .tobytes(), int(n[i]))
            elif family == "gap":
                sm, ops, n, evaluated = res
                if not evaluated[i]:
                    continue
                ans = (int(sm[i]), np.asarray(ops[i, :int(n[i])],
                                              dtype=np.int8).tobytes(),
                       int(n[i]))
            else:   # rb
                vals, pos, evaluated = res
                if not evaluated[i]:
                    continue
                w = len(problems[i][1]) + 1
                ans = (np.asarray(vals[i, :w], dtype=np.int64).copy(),
                       np.asarray(pos[i, :w], dtype=np.int64).copy())
            recs.append((family, tuple(problems[i]), ans))
        self._save(recs)

    def install(self, offload) -> None:
        """Wrap the offload entries of ``offload`` (the port's
        ``ops.offload`` module)."""
        for family, name in ENTRIES.items():
            orig = getattr(offload, name)
            self.originals[name] = orig

            def wrapper(*args, _orig=orig, _family=family):
                res = _orig(*args)
                if self.armed:
                    self._record(_family, args, res)
                return res
            setattr(offload, name, wrapper)

    def uninstall(self, offload) -> None:
        for name, orig in self.originals.items():
            setattr(offload, name, orig)
        self.originals = {}

    def load(self) -> list:
        recs = []
        for path in sorted(glob.glob(os.path.join(self.dir, "*.pkl"))):
            with open(path, "rb") as f:
                while True:
                    try:
                        recs += pickle.load(f)
                    except EOFError:
                        break
        return recs

    def clear(self) -> None:
        for path in glob.glob(os.path.join(self.dir, "*.pkl")):
            os.remove(path)

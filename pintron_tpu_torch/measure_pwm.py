"""``pwm_kernel`` at the shapes STEP 4 gives it: one launch per BPS
matrix of every window of the locus's sweep, 3708 windows on TP53 and
8425 on issue-13, 12 bases wide.  Each batch is held bit for bit
against the plain version and timed two ways with CUDA events: the
call (back-to-back calls, what the stage pays, the host's dispatch
included) and the card alone (the calls queued behind a sleep of the
stream).  ``F.conv1d`` over the one-hot codes, the one PyTorch call
that computes the same scores (cuDNN's TF32 off), is timed beside it
the same two ways; the port never calls it.

    python -m pintron_tpu_torch.measure_pwm [--old PWM_CU] [--out FILE]

``--old`` builds another version of ``csrc/pwm.cu`` (the same C entry
point), checks it too, and times it in turns with this checkout's
kernel (old, new, new, old) in one process on one card.  Writes
``chiprun_out/pwm_measure.json`` by default and prints one line per
shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from pintron_tpu_torch.measure_kband import build_other, cuda_ms, device_ms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (locus, windows a launch): the sweep's batch per BPS matrix
STEP4_SHAPES = (("TP53", 3708), ("issue-13", 8425))
L = 12


def build_old(src: str):
    """Build another version of pwm.cu and return a launcher with the
    wrapper's arguments."""
    lib = build_other(src, "pwm-old")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pintron_pwm.restype = I
    lib.pintron_pwm.argtypes = [P, I, P, ctypes.c_float, P, I, P]

    def launch(codes, w, den):
        B = codes.shape[0]
        out = torch.empty(B, dtype=torch.float32, device=codes.device)
        err = lib.pintron_pwm(codes.data_ptr(), codes.shape[1], w.data_ptr(),
                              den, out.data_ptr(), B,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old pwm_kernel launch failed: {err}")
        return out
    return launch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", default="",
                   help="another version of csrc/pwm.cu to time beside "
                        "this checkout's")
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "pwm_measure.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_pwm: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from pintron_tpu_torch.ops import _build, pwm
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    _build.load()
    old = build_old(args.old) if args.old else None
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(20261016)
    rows = []
    for locus, B in STEP4_SHAPES:
        for name in ("BPS_9", "BPS_10"):
            wpwm, den = pwm.pwm_tables(name)
            w = torch.from_numpy(wpwm).to(dev)
            c = torch.from_numpy(rng.integers(0, 4, (B, L)).astype(
                np.int8)).to(dev)
            want = pwm.pwm_scores(c, w, den)
            runs = {"new": lambda: pwm.pwm_scores_cuda(c, w, den)}
            if old is not None:
                runs["old"] = lambda: old(c, w, den)
            for key, fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{locus} {name}: {key} kernel != "
                                         f"plain on {int((got != want).sum())}"
                                         " windows")
            onehot = torch.nn.functional.one_hot(c.long(), 4).permute(
                0, 2, 1).to(torch.float32).contiguous()
            weight = (w / torch.tensor(den, dtype=torch.float32,
                                       device=dev))[None]
            runs["F.conv1d"] = lambda: torch.nn.functional.conv1d(onehot,
                                                                   weight)
            order = list(runs) + list(runs)[::-1]
            rec = {"locus": locus, "matrix": name, "B": B, "L": L,
                   "gpu": gpu, "call_ms": {k: [] for k in runs},
                   "device_ms": {k: [] for k in runs}}
            for key in order:
                rec["call_ms"][key].append(cuda_ms(runs[key], 50))
                rec["device_ms"][key].append(device_ms(runs[key], 50))
            rows.append(rec)
            print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": gpu, "shapes": rows}, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device evaluation of the est-fact DP problem batches.

The port's counterpart of the JAX package's ``ops/offload.py`` for the
four families of STEP 2: K-band (``eval_kband``), endpoint NW
(``eval_nw``), refine-borders (``eval_rb``) and gap alignment
(``eval_gap``).

The native collect pass (``est_collect_noisy`` in dp.c) lists every
noisy-exon K-band check the filter cascade will need (reference:
est-factorizations.c:1828-1899 -> compute-alignments.c:319-453);
``eval_kband`` evaluates the whole cross-EST batch with the K-band
kernels (``pintron_tpu_torch.ops.kband``, bit-equal to the C
``kband_core``), and the stage pre-fills the verdicts into the native
memo (``epm_fill_noisy``) so the cascade memo-hits every exon.

Routing mirrors ``ep_kband`` (dp.c) exactly:
  * equal sequences           -> ok (no DP)
  * zero error budget         -> not ok
  * length gap > budget       -> not ok
  * band covers the matrix    -> full edit distance (batched)
  * otherwise                 -> K-band DP (batched)

The NW, rb and gap entries take (est_window, gen_window) or
(text_window, pattern) pairs from the other native collect passes and
return the per-problem tracebacks or row tables the native fill calls
read.  Unlike the JAX package's entries, which decline a whole batch
when one problem is oversized, they leave each oversized problem to the
host DP and say which problems they evaluated.

Stage 4's two device sites have their entries here too: the PWM window
scores of the branch-point sweep (``pwm_scores_batched``) and the edit
distances of the predicted-introns stats (``eval_edit_batch``).

The device is a module setting made by the caller (``use_device``).  On
a CPU device the wrappers run the plain PyTorch versions.  With
``PINTRON_TORCH_SERVICE`` set, every entry sends its batch to the
GPU-owning service (``pintron_tpu_torch.devservice``) instead, and the
process never creates a CUDA context, nor loads torch: torch and the
kernel wrappers load with the first batch evaluated in this process
(``_local``), and a client holds its device by name (``DeviceName``).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import os
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from pintron_tpu_torch.ops.limits import KMAX, MAX_WIDTH
from pintron_tpu_torch.runtime import timing

# torch and the kernel wrappers, by the module that holds each: bound in
# this module by the first batch evaluated here (``_load``), never by a
# service client's, which sends its batches away.  They read as module
# attributes all the same (``offload.batch_nw_traceback_cuda``: reading
# one loads them), and a stand-in set on the module stays.
_KBAND = "pintron_tpu_torch.ops.kband"
_TRACEBACK = "pintron_tpu_torch.ops.traceback"
_LAZY = {"torch": "torch", "from_numpy_batch": "pintron_tpu_torch.ops.align",
         "banded_edit_distance_cuda": _KBAND,
         "batch_edit_distance_score_cuda": _KBAND,
         "pwm_scores_cuda": "pintron_tpu_torch.ops.pwm",
         "batch_edit_rowmin_cuda": _TRACEBACK,
         "batch_gap_traceback_cuda": _TRACEBACK,
         "batch_nw_traceback_cuda": _TRACEBACK, "gap_rows": _TRACEBACK,
         "gap_scratch": _TRACEBACK, "nw_scratch": _TRACEBACK}


def _load() -> None:
    """Bind torch and the kernel wrappers here; a name bound already
    stays."""
    names = globals()
    for name, modname in _LAZY.items():
        if name not in names:
            mod = importlib.import_module(modname)
            names[name] = mod if name == modname else getattr(mod, name)


def __getattr__(name: str):
    if name in _LAZY:
        _load()
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class DeviceName(NamedTuple):
    """A device by type and index, as a service client holds it: no
    torch.device, so that the client never loads torch.  ``str`` reads
    as torch.device's (``cuda``, ``cuda:0``, ``cpu``)."""
    type: str
    index: Optional[int] = None

    @classmethod
    def of(cls, device) -> "DeviceName":
        name = str(device)
        kind, colon, index = name.partition(":")
        if kind not in ("cuda", "cpu") or (colon and not index.isdigit()):
            raise ValueError(f"unsupported device {name}")
        return cls(kind, int(index) if colon else None)

    def __str__(self) -> str:
        return self.type if self.index is None else f"{self.type}:{self.index}"


def _local(device) -> "torch.device":
    """``device`` as a torch.device, for a batch evaluated in this
    process; loads torch and the kernel wrappers."""
    _load()
    return torch.device(str(device))


def _p2(x: int, lo: int = 16) -> int:
    v = lo
    while v < x:
        v <<= 1
    return v


def _p4(x: int, lo: int = 16) -> int:
    """Power-of-four bucket for the sequence-length axes: few distinct
    shapes, so a typical batch is one band and one full launch."""
    v = lo
    while v < x:
        v <<= 2
    return v


def _encode(seqs: Sequence[bytes], width: int, rows: int = 0):
    """Pack byte strings into a padded int8 code batch (bytes >= 128
    wrap negative; the kernels compare codes for equality only).
    ``rows`` pads the batch axis with all-zero problems."""
    B = max(len(seqs), rows)
    out = np.zeros((B, width), dtype=np.int8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s, dtype=np.uint8)
        out[i, : len(b)] = b.astype(np.int8)
        lens[i] = len(b)
    return out, lens


# running counters for benchmarks/diagnostics: problems seen, problems
# evaluated on the device (all families, and per family for NW, rb, gap
# and the stage-4 edit stats), PWM windows scored, DP cells computed
# there; counted as the JAX package counts them, and the same whether a
# batch runs here or on the service.
# ``kband_ub_max`` is no count but the widest budget of a K-band problem
# sent to the band kernel (over 256, ``kband_kernel``'s 33-cells-a-lane
# instance); the others are sums.  ``mesh_batches`` counts the K-band
# groups sharded over a mesh of more than one shard (PINTRON_TORCH_MESH).
# Batches of two families run at once (the executor thread's K-band and
# gap batches beside this thread's NW and rb batches), so the counters
# are added to under a lock.
STATS = {"problems": 0, "device_problems": 0, "device_cells": 0,
         "nw_problems": 0, "gap_problems": 0, "rb_problems": 0,
         "edit_problems": 0, "pwm_windows": 0,
         "batches": 0, "device_runs": 0, "device_timeouts": 0,
         "mesh_batches": 0, "kband_ub_max": 0}
# Where each STEP 2 family ran (the routes and the self-tuner below),
# for kband, nw, gap and rb: ``<f>_on_host`` counts the batch
# opportunities left to the host DP (switch at 0, latched skip, or
# auto's small-batch gate), ``<f>_skips`` the latched skips among them,
# ``<f>_probes`` the re-probes armed, ``<f>_reports`` the batches the
# tuner timed and ``<f>_latched`` those of them after which the family
# was latched off.
FAMILIES = ("kband", "nw", "gap", "rb")
TUNE_COUNTS = ("on_host", "skips", "probes", "reports", "latched")
STATS.update({f"{fam}_{c}": 0 for fam in FAMILIES for c in TUNE_COUNTS})
# ``<f>_too_wide`` for nw, gap and rb: the problems a family left to the
# host DP for their size (over TRACEBACK_BOUND or MAX_WIDTH, below)
STATS.update({f"{fam}_too_wide": 0 for fam in ("nw", "gap", "rb")})
_MAXIMA = ("kband_ub_max",)
# the (N, M) buckets each traceback family launched, with their
# launches: the kernels' layouts and passes a run reached
BUCKETS = {"nw": {}, "gap": {}, "rb": {}}
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    """Zero the counters; the tuner's latches stay (``reset_tuner``)."""
    with _STATS_LOCK:
        for k in STATS:
            STATS[k] = 0
        for launched in BUCKETS.values():
            launched.clear()


def _tally_bucket(family: str, N: int, M: int) -> None:
    with _STATS_LOCK:
        launched = BUCKETS[family]
        launched[N, M] = launched.get((N, M), 0) + 1


def tally(**counts: int) -> None:
    """Add to the STATS counters (raise the maxima)."""
    with _STATS_LOCK:
        for k, n in counts.items():
            STATS[k] = max(STATS[k], n) if k in _MAXIMA else STATS[k] + n


# ---- per-family routes and the self-tuner --------------------------------
# PINTRON_DEVICE_{KBAND,NW,GAP,RB} route one DP family of the STEP 2
# device flow each (the JAX package's switches, same names):
#   unset, empty or "1"  the card, forced: the tuner is never consulted;
#   "0"                  the host's native DP computes the family inside
#                        the cascade, as with no device;
#   "auto"               the self-tuner: each timed batch against the
#                        family's host estimate latches it off or on.
# Any other value raises (the JAX package reads it as auto).  No route
# is a fallback: a batch that fails or times out raises under every
# value, and the flow never leaves the card whole (the JAX package's
# run-level bypass when all four latch off is not ported; the host path
# is ``device="host"``).

CARD, HOST_DP, AUTO = "card", "host", "auto"
_ROUTE_OF = {"": CARD, "1": CARD, "0": HOST_DP, "auto": AUTO}


def family_env(family: str) -> str:
    return f"PINTRON_DEVICE_{family.upper()}"


def family_routes() -> dict:
    """{family: "card" | "host" | "auto"} from the four switches;
    raises ValueError on any other value."""
    routes = {}
    for fam in FAMILIES:
        value = os.environ.get(family_env(fam), "")
        if value not in _ROUTE_OF:
            raise ValueError(f"{family_env(fam)}={value!r}: use 1 (the card, "
                             "the default), 0 (the host DP) or auto (the "
                             "self-tuner)")
        routes[fam] = _ROUTE_OF[value]
    return routes


# The tuner's policy is the JAX package's (offload.py:424-481): latch a
# family off when a timed batch took over LATCH_RATIO times its host
# estimate, clear the latch under CLEAR_RATIO times it, hold in between;
# while latched, every TUNE_REPROBE_EVERY-th opportunity arms a re-probe
# that passes every gate until its measurement lands.  Its absolute
# floors (a batch under LATCH_FLOOR_S never latches, one under
# CLEAR_FLOOR_S always clears; the JAX package's 4 ms and 2 ms are a TPU
# link's), its host estimates and the small-batch gates are the card
# machine's own, measured by ``python -m pintron_tpu_torch.measure_host_dp``
# beside an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, on its
# host's CPU (8 CPUs, GenuineIntel family 6 model 207 at 2489 MHz; its
# /proc/cpuinfo names no model), torch 2.11.0+cu128:
#   CALL_FLOOR_S     the slowest family's median entry call on a batch of
#                    one problem (K-band; NW 0.836, gap 0.813, rb 0.782
#                    ms): the dispatch thread, the copies and the launch;
#   HOST_S_PER_CELL  the port's native host DP (the cascade's own C
#                    functions, one thread) over the 9581 K-band, 6251
#                    NW, 5401 gap and 6530 rb problems STEP 2 sends on
#                    TP53 and issue-13, seconds a cell as ``tune_cells``
#                    counts them (rb's small problems pay a ctypes call
#                    each, which the cascade does not);
#   *_MIN_BATCH      the fewest problems whose host estimate, at the
#                    main path's mean cells a problem (rb 566, gap
#                    35405), reaches CALL_FLOOR_S: auto leaves a smaller
#                    rb or gap batch to the host DP.
# A second run on another machine of the same kind read a 1.28 ms floor
# and host rates 5-50% slower (PERF.md): the constants are that close.
TUNE_REPROBE_EVERY = 8
LATCH_RATIO, CLEAR_RATIO = 2.0, 1.2
CALL_FLOOR_S = 0.000931
LATCH_FLOOR_S = 2 * CALL_FLOOR_S
CLEAR_FLOOR_S = CALL_FLOOR_S
HOST_S_PER_CELL = {"kband": 1.343e-9, "nw": 3.931e-10, "gap": 4.729e-10,
                   "rb": 2.904e-9}
RB_MIN_BATCH = 567
GAP_MIN_BATCH = 56

_TUNED_OFF = dict.fromkeys(FAMILIES, False)
_TUNE_SKIPS = dict.fromkeys(FAMILIES, 0)
_PROBE_PENDING = dict.fromkeys(FAMILIES, False)
# the executor thread reports K-band and gap batches while this thread
# reports NW and rb ones
_TUNE_LOCK = threading.Lock()


def tuned_off(family: str) -> bool:
    """One opportunity of a family under the tuner: True while it is
    latched off, except that every TUNE_REPROBE_EVERY-th opportunity
    arms a re-probe, and an armed family answers False until
    ``tune_report`` records the probe's batch."""
    with _TUNE_LOCK:
        if not _TUNED_OFF[family] or _PROBE_PENDING[family]:
            return False
        _TUNE_SKIPS[family] += 1
        if _TUNE_SKIPS[family] >= TUNE_REPROBE_EVERY:
            _TUNE_SKIPS[family] = 0
            _PROBE_PENDING[family] = True
            tally(**{f"{family}_probes": 1})
            return False
        tally(**{f"{family}_skips": 1})
        return True


def tune_report(family: str, elapsed: float, host_est: float) -> None:
    """Record one timed batch of a family: latch it off when it took
    over LATCH_RATIO times the host estimate (and LATCH_FLOOR_S), clear
    the latch under CLEAR_RATIO times it (or CLEAR_FLOOR_S), keep the
    state in between."""
    with _TUNE_LOCK:
        _PROBE_PENDING[family] = False
        if elapsed > max(LATCH_RATIO * host_est, LATCH_FLOOR_S):
            _TUNED_OFF[family] = True
            _TUNE_SKIPS[family] = 0
        elif elapsed < max(CLEAR_RATIO * host_est, CLEAR_FLOOR_S):
            _TUNED_OFF[family] = False
        tally(**{f"{family}_reports": 1,
                 f"{family}_latched": int(_TUNED_OFF[family])})


def on_card(family: str, route: str) -> bool:
    """One batch opportunity of a family under its route: True sends
    the batch to the card; False leaves it to the host DP (counted)."""
    if route == CARD or (route == AUTO and not tuned_off(family)):
        return True
    tally(**{f"{family}_on_host": 1})
    return False


def tune_cells(family: str, problems) -> int:
    """The DP cells of a family's batch, as the JAX device flow counts
    them for its host estimates (est_fact.py:1117-1122, 1249-1260,
    1354-1355, 1462-1478): NW len(e)·len(g), rb (|t|+1)(|p|+1), gap
    3(n+1)(m+1); K-band m·(2ub+1), or n·m where the band covers the
    matrix, for the problems that reach a DP."""
    if family == "nw":
        return sum(len(e) * len(g) for e, g in problems)
    if family == "rb":
        return sum((len(t) + 1) * (len(p) + 1) for t, p in problems)
    if family == "gap":
        return sum(3 * (len(e) + 1) * (len(g) + 1) for e, g in problems)
    cells = 0
    for g, e, ub in problems:
        if ub == 0 or g == e:
            continue
        n, m = (len(g), len(e)) if len(g) >= len(e) else (len(e), len(g))
        if n - m <= ub:
            cells += n * m if 2 * ub + 1 >= n else m * (2 * ub + 1)
    return cells


def host_estimate(family: str, problems) -> float:
    """Seconds the host DP would take for a family's batch."""
    return tune_cells(family, problems) * HOST_S_PER_CELL[family]


def latches() -> dict:
    """{family: latched off} of the tuner."""
    with _TUNE_LOCK:
        return dict(_TUNED_OFF)


def inherit_latches(latched: dict) -> None:
    """Take a forked worker's latches into this process's (OR), so that
    later forks inherit them.  The workers ran and measured any probe
    armed here, so the pending probes are cleared."""
    with _TUNE_LOCK:
        for fam, off in latched.items():
            _TUNED_OFF[fam] = _TUNED_OFF[fam] or off
        for fam in FAMILIES:
            _PROBE_PENDING[fam] = False


def reset_tuner() -> None:
    """Clear every latch, skip count and armed probe (``reset_stats``
    leaves them alone: they are tuning state, not statistics)."""
    with _TUNE_LOCK:
        for fam in FAMILIES:
            _TUNED_OFF[fam] = _PROBE_PENDING[fam] = False
            _TUNE_SKIPS[fam] = 0


def _new_locks() -> None:
    """In a forked child: locks a parent thread may have held."""
    global _STATS_LOCK, _TUNE_LOCK
    _STATS_LOCK, _TUNE_LOCK = threading.Lock(), threading.Lock()


os.register_at_fork(after_in_child=_new_locks)


_DEVICE = None


def set_device(device) -> None:
    """Select the device the batches run on (held by name)."""
    global _DEVICE
    _DEVICE = DeviceName.of(device)


HOST = "host"


def is_host(device) -> bool:
    """True for the entry points' ``device="host"``: the native host
    path with no device batch (the JAX package's default mode).  The
    other values are devices (``use_device``); None is none of them."""
    if device is None:
        raise ValueError("device=None: pass 'cuda', 'cuda:N', 'cpu' or "
                         f"'{HOST}'")
    return isinstance(device, str) and device == HOST


def check_card(device) -> torch.device:
    """``device`` (``"cuda"``, ``"cuda:N"`` or ``"cpu"``) as a
    torch.device; a CUDA device raises when no card is available."""
    if device is None:
        raise ValueError("device=None: pass 'cuda', 'cuda:N' or 'cpu'")
    _load()
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device}: torch.cuda.is_available() is "
                           "false")
    return device


def use_device(device):
    """Check and select the device of this process's batches
    (``"cuda"``, ``"cuda:N"`` or ``"cpu"``) and return it as a
    torch.device.  ``cuda`` raises when no CUDA device is available,
    unless the batches go to the service, which owns the device: this
    process then never touches CUDA nor loads torch, returns the device
    as a ``DeviceName``, and the service's must be of the same type.
    Batches that run here on the CPU (the plain versions: row-serial
    loops of small tensor ops) take one intra-op thread: with the
    host's other cores busy (test workers, a batch's jobs, a CPU
    service's clients), a pool of threads waiting on one another at
    every small op made the plain NW of 788's widest launch many times
    slower than one thread."""
    if is_host(device):
        raise ValueError(f"device={HOST!r} has no device batches")
    if service_socket() is None:
        device = check_card(device)
        if device.type == "cpu":
            torch.set_num_threads(1)
    else:
        device = DeviceName.of(device)
        _check_served(service_device(), device)
    set_device(device)
    return device


# ---- the device service client ---------------------------------------------
# PINTRON_TORCH_SERVICE=<unix socket> sends every batch of this process
# to the GPU-owning service: the process never creates a CUDA context,
# so it may fork (STEP 2's sharded flow, the batch driver's workers),
# and the service merges concurrent clients' batches.  The variable is
# the port's own, so the JAX package (PINTRON_DEVICE_SERVICE) never
# reaches a torch service, nor the port a JAX one.  A client checks on
# connecting that the service runs on its own device type, so a cuda
# run never lands on a cpu service.  A service error is raised here, as
# a failed kernel is; a service that hangs trips device_call's timeout
# like a hung device.

SERVICE_ENV = "PINTRON_TORCH_SERVICE"
AUTHKEY = b"pintron-torch-devservice"
_SERVICE = None   # (socket path, Connection, the service's DeviceName)
_SERVICE_LOCK = threading.Lock()   # one request in flight per connection


def service_socket():
    return os.environ.get(SERVICE_ENV) or None


def _forget_service() -> None:
    """In a forked child: drop the parent's connection (and a lock a
    parent thread may have held) so the child dials its own."""
    global _SERVICE, _SERVICE_LOCK
    _SERVICE = None
    _SERVICE_LOCK = threading.Lock()


os.register_at_fork(after_in_child=_forget_service)


def _dial(addr: str):
    """Connect to the service and take its ``hello`` answer: (Connection,
    the service's device name)."""
    from multiprocessing.connection import Client
    conn = Client(addr, family="AF_UNIX", authkey=AUTHKEY)
    try:
        conn.send(("hello", None))
        _status, served = conn.recv()
    except BaseException:
        conn.close()
        raise
    return conn, served


def _service_conn():
    """This process's connection to the service, dialled on first use
    (under _SERVICE_LOCK); returns (Connection, the service's device).
    The dial and the handshake run under the dispatch timeout: the
    service answers ``hello`` only between batches, so a service stuck
    in a batch raises DeviceTimeout here as the batch would."""
    global _SERVICE
    addr = service_socket()
    if _SERVICE is None or _SERVICE[0] != addr:
        conn, served = device_call(
            _dial, addr, what=f"device service handshake at {addr}")
        _SERVICE = (addr, conn, DeviceName.of(served))
    return _SERVICE[1], _SERVICE[2]


def service_device():
    """The device of the service this process's batches go to, or None
    when no service is set."""
    if service_socket() is None:
        return None
    with _SERVICE_LOCK:
        return _service_conn()[1]


def _check_served(served: DeviceName, device) -> None:
    if served.type != device.type:
        raise RuntimeError(f"device service at {service_socket()} runs on "
                           f"{served}, not on the {device} asked for")


def problem_count(op: str, payload) -> int:
    """The problems of one request (a PWM request's windows); 0 for a
    payload of no known shape."""
    if op == "pwm":
        payload = payload[0] if isinstance(payload, tuple) and payload else ()
    return len(payload) if hasattr(payload, "__len__") else 0


def service_eval(op: str, payload, device):
    """Round-trip one batch through the service.  Returns its result,
    or None when no service is set; raises the service's error, and
    raises when the service's device is not of ``device``'s type."""
    if service_socket() is None:
        return None
    with timing.span("pintron_service_call", op=op,
                     problems=problem_count(op, payload)), _SERVICE_LOCK:
        conn, served = _service_conn()
        _check_served(served, device)
        conn.send((op, payload))
        status, res = conn.recv()
    if status != "ok":
        raise RuntimeError(f"device service: {res}")
    return res


# ---- bounded dispatch ----------------------------------------------------
# A hung device must not hang the pipeline: every batch runs under
# device_call(), a wall-clock-bounded worker thread.  A batch that
# passes the timeout (PINTRON_DEVICE_TIMEOUT_S, default 600 s) raises
# DeviceTimeout, as any other failure (a kernel that does not build or
# launch, a bad batch) is raised: the port never moves work to the CPU
# when a device was asked for.


class DeviceTimeout(RuntimeError):
    """A device batch ran past the dispatch timeout."""


def device_call(fn, *args, what: str = "device batch"):
    """Run fn(*args) bounded by the device dispatch timeout.  Returns
    its result; raises DeviceTimeout when the timeout passes, and
    re-raises what fn raised."""
    timeout = float(os.environ.get("PINTRON_DEVICE_TIMEOUT_S", "600"))
    if timeout <= 0:  # explicit opt-out: unbounded inline call
        return fn(*args)
    box: dict = {}
    fn = timing.bind(fn)

    def work():
        try:
            box["ok"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    t = threading.Thread(target=work, daemon=True,
                         name="pintron-device-dispatch")
    t.start()
    t.join(timeout)
    if t.is_alive():
        tally(device_timeouts=1)
        raise DeviceTimeout(f"{what} exceeded the {timeout:g} s device "
                            "dispatch timeout (PINTRON_DEVICE_TIMEOUT_S)")
    if "err" in box:
        raise box["err"]
    return box.get("ok")


def _device() -> DeviceName:
    if _DEVICE is None:
        raise RuntimeError("offload.set_device() was not called")
    return _DEVICE


def eval_kband(problems: List[Tuple[bytes, bytes, int]]):
    """Bounded entry point: evaluate the batch on the device set with
    ``set_device``.  A failed or timed-out batch raises."""
    return device_call(_eval_kband_device, problems, _device(),
                       what="K-band device batch")


# ---- the K-band groups over a device mesh ----------------------------------
# PINTRON_TORCH_MESH=N (N > 1) shards each K-band group, on the band and
# the full-matrix route, over make_mesh(N) on the batch's device: the
# per-problem independence axis of the reference (main-est-fact.c:249-291)
# made explicit across devices.  Each shard launches the same kernel on
# its contiguous chunk of the group, and the distances come back in
# order.  The DP is elementwise over problems, so the verdicts equal the
# unsharded ones.
# The variable is the port's own: the JAX package's PINTRON_DEVICE_MESH
# never reaches the port (run_est_fact refuses it).  Inside the device
# service the service's own environment decides.

MESH_ENV = "PINTRON_TORCH_MESH"


def mesh_size() -> int:
    """The shard count PINTRON_TORCH_MESH asks for (1: no mesh)."""
    return max(1, int(os.environ.get(MESH_ENV, "0") or 0))


def _sharded_call(mesh, fn, arrays):
    """Run ``fn`` (a K-band wrapper with its static arguments bound) over
    ``mesh``: every numpy array split into contiguous chunks on its
    leading (problem) axis, one a shard, on the shard's device
    (``parallel.mesh.map_shards``).  Returns the per-problem distances in
    order on the mesh's first device.  A mesh of one shard is the plain
    call; each call over more adds one to ``STATS["mesh_batches"]``."""
    from pintron_tpu_torch.parallel.mesh import map_shards
    _load()
    if len(mesh.devices) > 1:
        tally(mesh_batches=1)
    outs = map_shards(mesh, lambda _dev, *chunk: (fn(*chunk),),
                      *from_numpy_batch(*arrays, device="cpu"))
    return torch.cat([d for d, in outs])


def _full_matrix(n: int, ub: int) -> bool:
    """A K-band problem goes to the full-matrix kernel when its band
    covers the matrix, or is wider than the band kernel takes (ub >
    KMAX = 512, exons over about 17 kb).  The verdict dist <= ub is the
    same either way: a path of cost <= ub never leaves the band of
    half-width ub.  The JAX package sends every budget to its band op,
    so only the cells of a budget over 512 are counted differently
    (len(a) * len(b) here, len(b) * (2ub+1) there)."""
    return 2 * ub + 1 >= n or ub > KMAX


def _eval_kband_device(problems: List[Tuple[bytes, bytes, int]],
                       device) -> np.ndarray:
    """Evaluate a batch of (gen_window, est_window, max_err) K-band
    problems on ``device``.  Returns int64 ok flags with ep_kband's
    exact semantics (dp.c:3862-3878)."""
    # Trivial verdicts (equal strings, zero budget, length gap over
    # budget: ep_kband's short-circuits) are answered here; only the
    # residue needing a real DP reaches the device.
    ok = np.zeros(len(problems), dtype=np.int64)
    rest = []
    for i, (g, e, ub) in enumerate(problems):
        if len(g) == len(e) and g == e:
            ok[i] = 1
            continue
        if ub == 0:
            continue
        a, b = (g, e) if len(g) >= len(e) else (e, g)
        if len(a) - len(b) > ub:
            continue
        rest.append((i, a, b, ub))
    tally(problems=len(problems))
    if not rest:
        return ok
    tally(device_problems=len(rest),
          device_cells=sum(len(a) * len(b) if _full_matrix(len(a), ub)
                           else len(b) * (2 * ub + 1)
                           for _, a, b, ub in rest),
          kband_ub_max=max((ub for _, a, _b, ub in rest
                            if not _full_matrix(len(a), ub)), default=0))
    r = service_eval("kband", [(a, b, ub) for _, a, b, ub in rest],
                     device)
    if r is not None:
        tally(batches=1)
        ok[[i for i, _a, _b, _ub in rest]] = r
        return ok
    device = _local(device)

    full_groups = {}
    band_groups = {}
    for i, a, b, ub in rest:
        n = len(a)
        # every problem with n <= 1024 shares ONE bucket padded to 1024;
        # only longer outliers get their own power-of-four class
        key = 1024 if n <= 1024 else _p4(n)
        if _full_matrix(n, ub):
            full_groups.setdefault(key, []).append((i, a, b, ub))
        else:
            band_groups.setdefault(key, []).append((i, a, b, ub))

    # Launch every group before reading any result back: launches are
    # asynchronous, so later groups' host-side encoding overlaps
    # earlier groups' device work.  Each route's span runs from its
    # first launch until every result is read back, so the kernels run
    # inside the spans.
    from pintron_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(mesh_size(), device)
    pending = []
    with (timing.span("pintron_kband_full") if full_groups
          else contextlib.nullcontext()):
        for N, items in sorted(full_groups.items()):
            M = _p4(max(len(b) for _, _, b, _ in items))
            Bp = _p2(len(items), lo=64)
            s1, l1 = _encode([a for _, a, _, _ in items], N, rows=Bp)
            s2, l2 = _encode([b for _, _, b, _ in items], M, rows=Bp)
            r = _sharded_call(mesh, functools.partial(
                batch_edit_distance_score_cuda, max_rows=M),
                [s1, l1, s2, l2])
            pending.append((items, r))
            tally(batches=1)

        with (timing.span("pintron_kband_band") if band_groups
              else contextlib.nullcontext()):
            for N, items in sorted(band_groups.items()):
                M = _p4(max(len(b) for _, _, b, _ in items))
                K = _p2(max(ub for _, _, _, ub in items), lo=2)
                Bp = _p2(len(items), lo=64)
                s1, l1 = _encode([a for _, a, _, _ in items], N, rows=Bp)
                s2, l2 = _encode([b for _, _, b, _ in items], M, rows=Bp)
                band = np.zeros(Bp, dtype=np.int32)
                band[:len(items)] = [ub for _, _, _, ub in items]
                r = _sharded_call(mesh, functools.partial(
                    banded_edit_distance_cuda, max_rows=M, k_max=K),
                    [s1, l1, s2, l2, band])
                pending.append((items, r))
                tally(batches=1)

            for items, r in pending:
                rn = r.cpu().numpy()
                for (i, _a, _b, ub), dist in zip(items, rn):
                    ok[i] = int(dist) <= ub

    return ok


# ---- the traceback families ------------------------------------------------
# Which problems reach nw_kernel and gap_kernel: the kernels' own bound,
# not a device's, so that cpu and cuda route the same problems.  The gen
# window is a DP row, at most MAX_WIDTH wide (its power-of-four bucket
# is then at most MAX_WIDTH too, a power of four); the kernels take the
# est window in passes, and the same bound on it caps a problem's
# scratch at that of the widest (MAX_WIDTH, MAX_WIDTH) bucket, which
# every launch budget holds (``launch_budget``).  A wider problem goes
# to the host DP and is counted in ``<family>_too_wide``; the gap
# collect applies the bound itself (``ri_dev_set_bounds`` in dp.c).
# rb's text window is a DP row of rowmin_kernel, at most MAX_WIDTH too.
TRACEBACK_BOUND = (MAX_WIDTH, MAX_WIDTH)


def traceback_fits(e: bytes, g: bytes) -> bool:
    return len(e) <= TRACEBACK_BOUND[0] and len(g) <= TRACEBACK_BOUND[1]


def scratch_bytes(family: str, N: int, M: int) -> int:
    """The kernel scratch of one problem in an (N, M) bucket: what
    ``traceback.nw_scratch`` or ``gap_scratch`` (at ``gap_rows(N)``)
    allocates for a batch of one; both grow linearly in the batch."""
    _load()
    if family == "nw":
        bufs = nw_scratch(1, N, M, "meta")
    else:
        bufs = gap_scratch(1, N, M, "meta", gap_rows(N))
    return sum(t.numel() * t.element_size() for t in bufs)


# The kernel scratch one launch may take.  On a card, 1/LAUNCH_SHARE of
# its memory, read once a device: 9.9 GiB of the 79.2 GiB
# (85,017,493,504 bytes) of an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit, where the widest NW problem needs 64 MiB and the widest gap
# problem 160 MiB.  A process has two launches in flight at most (the
# executor thread's gap batch beside this thread's NW batch; the device
# service evaluates one batch at a time), a quarter of the card.  The
# plain versions on the CPU materialize a byte a cell, up to four times
# the kernels' scratch, so CPU_LAUNCH_BUDGET holds at most 2 GiB of
# their directions.
LAUNCH_SHARE = 8
CPU_LAUNCH_BUDGET = 1 << 29
_BUDGETS = {}


def launch_budget(device) -> int:
    """Bytes of kernel scratch one traceback launch on ``device`` may
    take; raises when it cannot hold one problem of the widest
    bucket."""
    device = _local(device)
    if device.type == "cpu":
        return CPU_LAUNCH_BUDGET
    key = (device.type, device.index)
    if key not in _BUDGETS:
        budget = (torch.cuda.get_device_properties(device).total_memory
                  // LAUNCH_SHARE)
        widest = max(scratch_bytes(fam, *TRACEBACK_BOUND)
                     for fam in ("nw", "gap"))
        if budget < widest:
            raise RuntimeError(f"{device}: a launch budget of {budget} bytes "
                               f"holds no widest problem ({widest} bytes)")
        _BUDGETS[key] = budget
    return _BUDGETS[key]


def _buckets(problems, evaluated):
    """Group the evaluated problems by power-of-four (N, M) bucket."""
    groups = {}
    for i, (a, b) in enumerate(problems):
        if evaluated[i]:
            groups.setdefault((_p4(max(len(a), 1)), _p4(max(len(b), 1))),
                              []).append(i)
    return sorted(groups.items())


def _launch_chunks(problems, evaluated, family, budget):
    """[(N, M, rows)]: each (est, gen) bucket's problems in launches of
    as many as ``budget`` bytes of the family's scratch hold."""
    chunks = []
    for (N, M), rows in _buckets(problems, evaluated):
        sub = max(1, budget // scratch_bytes(family, N, M))
        chunks += [(N, M, rows[c0:c0 + sub])
                   for c0 in range(0, len(rows), sub)]
    return chunks


def _traceback_batches(problems, evaluated, device, kernel, family):
    """Launch every (est, gen) bucket, in launches within the device's
    scratch budget, before reading any result back.  Returns [(rows,
    result)] with the results on the host, in launch order, all of it
    one ``pintron_<family>`` span."""
    pending = []
    with timing.span(f"pintron_{family}"):
        for N, M, chunk in _launch_chunks(problems, evaluated, family,
                                          launch_budget(device)):
            s1, l1 = _encode([problems[i][0] for i in chunk], N)
            s2, l2 = _encode([problems[i][1] for i in chunk], M)
            r = kernel(*from_numpy_batch(s1, l1, s2, l2, device=device),
                       max_n=N, max_m=M)
            pending.append((np.asarray(chunk), r))
            tally(batches=1)
            _tally_bucket(family, N, M)
        return [(rows, tuple(t.cpu().numpy() for t in r))
                for rows, r in pending]


def eval_nw(problems: List[Tuple[bytes, bytes]]):
    """Bounded entry point: batched NW alignments with the traceback for
    the endpoint family (est-factorizations.c:2127-2301 head/tail
    trims).  Each problem is an (est_window, gen_window) pair.  Returns
    (ops, nsteps, evaluated): per-problem op codes (int8, from the END
    of the alignment backwards, stride = ops.shape[1]), their counts
    (int64), and which problems were evaluated (an oversized one is
    left to the host DP).  ``epm_fill_endpoints`` decodes the ops into
    the host ``nw_align_run``'s alignment.  A failed or timed-out
    batch raises."""
    return device_call(_eval_nw_device, problems, _device(),
                       what="endpoint NW device batch")


def _eval_nw_device(problems: List[Tuple[bytes, bytes]], device):
    evaluated = np.array([traceback_fits(e, g) for e, g in problems],
                         dtype=bool)
    L = max((len(e) + len(g) for e, g in problems), default=1)
    all_ops = np.zeros((len(problems), L), dtype=np.int8)
    all_n = np.zeros(len(problems), dtype=np.int64)
    on_card = evaluated.copy()
    for i, (e, g) in enumerate(problems):
        if evaluated[i] and e == g:
            # all-diagonal optimum (the host's shortcut): len(e) diag ops
            all_n[i] = len(e)
            on_card[i] = False
    rows = np.flatnonzero(on_card)
    tally(problems=len(problems), device_problems=len(rows),
          nw_problems=len(rows), nw_too_wide=int((~evaluated).sum()),
          device_cells=sum(len(problems[i][0]) * len(problems[i][1])
                           for i in rows))
    r = service_eval("nw", problems, device)
    if r is not None:
        tally(batches=1)
        return r
    device = _local(device)
    for rows, (_score, ops, nsteps) in _traceback_batches(
            problems, on_card, device, batch_nw_traceback_cuda, "nw"):
        w = min(L, ops.shape[1])
        all_ops[rows, :w] = ops[:, :w]
        all_n[rows] = nsteps
    return all_ops, all_n, evaluated


def eval_gap(problems: List[Tuple[bytes, bytes]]):
    """Bounded entry point: batched 3-matrix L/G/R gap alignments with
    the traceback for the intron-refinement family
    (refine-intron.c:560-806).  Each problem is an (est_window,
    gen_window) pair from est_collect_introns.  Returns (sm, ops,
    nsteps, evaluated): per-problem start matrix (int64), op codes
    (int8, from the END backwards, stride = ops.shape[1]), their counts
    (int64), and which problems were evaluated (an oversized one is
    left to the host DP).  The caller installs them in the window-keyed
    lookaside (``ri_lookaside_set``) that the native cascade decodes.
    A failed or timed-out batch raises."""
    return device_call(_eval_gap_device, problems, _device(),
                       what="gap-align device batch")


def _eval_gap_device(problems: List[Tuple[bytes, bytes]], device):
    evaluated = np.array([traceback_fits(e, g) for e, g in problems],
                         dtype=bool)
    L = max((len(e) + len(g) for e, g in problems), default=1)
    all_sm = np.zeros(len(problems), dtype=np.int64)
    all_ops = np.zeros((len(problems), L), dtype=np.int8)
    all_n = np.zeros(len(problems), dtype=np.int64)
    rows = np.flatnonzero(evaluated)
    tally(problems=len(problems), device_problems=len(rows),
          gap_problems=len(rows), gap_too_wide=int((~evaluated).sum()),
          device_cells=sum(3 * (len(problems[i][0]) + 1)
                           * (len(problems[i][1]) + 1) for i in rows))
    r = service_eval("gap", problems, device)
    if r is not None:
        tally(batches=1)
        return r
    device = _local(device)
    for rows, (sm, ops, nsteps) in _traceback_batches(
            problems, evaluated, device, batch_gap_traceback_cuda, "gap"):
        w = min(L, ops.shape[1])
        all_ops[rows, :w] = ops[:, :w]
        all_sm[rows] = sm
        all_n[rows] = nsteps
    return all_sm, all_ops, all_n, evaluated


def eval_rb(problems: List[Tuple[bytes, bytes]]):
    """Bounded entry point: batched refine-borders row tables.  Each
    problem is a (text_window, pattern) pair, the forward or reversed
    pass of one gap problem (refine.c:105-192); the caller submits both
    passes as independent problems.  Returns (vals, pos, evaluated):
    int64 arrays of shape (n, stride), stride = max(len(pattern)) + 1,
    with the per-row minima and FIRST minimal positions of each
    problem's (len(pattern)+1)-row edit DP (rows past it unspecified),
    and which problems were evaluated (a text window wider than
    MAX_WIDTH is left to the host DP).  A failed or timed-out batch
    raises."""
    return device_call(_eval_rb_device, problems, _device(),
                       what="refine-borders device batch")


def _eval_rb_device(problems: List[Tuple[bytes, bytes]], device):
    evaluated = np.array([len(t) <= MAX_WIDTH for t, _p in problems],
                         dtype=bool)
    stride = max((len(p) for _, p in problems), default=0) + 1
    vals = np.zeros((len(problems), stride), dtype=np.int64)
    pos = np.zeros((len(problems), stride), dtype=np.int64)
    on_card = np.flatnonzero(evaluated)
    tally(problems=len(problems), device_problems=len(on_card),
          rb_problems=len(on_card),
          rb_too_wide=len(problems) - len(on_card),
          device_cells=sum((len(problems[i][0]) + 1)
                           * (len(problems[i][1]) + 1) for i in on_card))
    r = service_eval("rb", problems, device)
    if r is not None:
        tally(batches=1)
        return r
    device = _local(device)
    pending = []
    with timing.span("pintron_rowmin"):
        for (N, M), rows in _buckets(problems, evaluated):
            s1, l1 = _encode([problems[i][0] for i in rows], N)
            s2, l2 = _encode([problems[i][1] for i in rows], M)
            r = batch_edit_rowmin_cuda(
                *from_numpy_batch(s1, l1, s2, l2, device=device),
                max_rows=M)
            pending.append((np.asarray(rows), r))
            tally(batches=1)
            _tally_bucket("rb", N, M)
        for rows, (v, q) in pending:
            w = min(stride, v.shape[1])
            vals[rows, :w] = v[:, :w].cpu().numpy()
            pos[rows, :w] = q[:, :w].cpu().numpy()
    return vals, pos, evaluated


# ---- stage 4 -----------------------------------------------------------------

def eval_edit_batch(pairs: List[Tuple[bytes, bytes]]):
    """Bounded entry point: batched full unit-cost edit distances
    (refine.c:50-83, the recurrence of the host
    ``factorize.alignments.edit_distance``) for the predicted-introns
    donor/acceptor stats (main-intron-agreement.c:804-904): two
    independent <= 15 nt window distances per (intron, supporting EST)
    pair.  Returns int64 distances; a failed or timed-out batch
    raises."""
    return device_call(_eval_edit_batch_device, pairs, _device(),
                       what="edit-distance device batch")


def _eval_edit_batch_device(pairs: List[Tuple[bytes, bytes]],
                            device) -> np.ndarray:
    out = np.zeros(len(pairs), dtype=np.int64)
    rest = []
    for i, (a, b) in enumerate(pairs):
        if a == b:
            continue  # distance 0, no DP
        # seq1 = the longer string (columns), seq2 = rows
        if len(a) < len(b):
            a, b = b, a
        rest.append((i, a, b))
    tally(problems=len(pairs))
    if not rest:
        return out
    tally(device_problems=len(rest), edit_problems=len(rest),
          device_cells=sum(len(a) * len(b) for _, a, b in rest))
    r = service_eval("edit", [(a, b) for _, a, b in rest], device)
    if r is not None:
        tally(batches=1)
        out[[i for i, _a, _b in rest]] = r
        return out
    device = _local(device)

    groups = {}
    for i, a, b in rest:
        groups.setdefault((_p4(len(a)), _p4(max(len(b), 1))),
                          []).append((i, a, b))
    pending = []
    with timing.span("pintron_edit"):
        for (N, M), items in sorted(groups.items()):
            Bp = _p2(len(items), lo=64)
            s1, l1 = _encode([a for _, a, _ in items], N, rows=Bp)
            s2, l2 = _encode([b for _, _, b in items], M, rows=Bp)
            r = batch_edit_distance_score_cuda(
                *from_numpy_batch(s1, l1, s2, l2, device=device),
                max_rows=M)
            pending.append((items, r))
            tally(batches=1)
        for items, r in pending:
            out[[i for i, _a, _b in items]] = r[:len(items)].cpu().numpy()
    return out


def pwm_scores_batched(rows: np.ndarray, wpwm: np.ndarray, den: float):
    """Bounded entry point: MatInspector scores of (B, L) int8 window
    codes against one cv-weighted (4, L) float32 matrix (the BPS
    sweep of ``pintron_tpu_torch.factorize.classify``).  Returns (B,)
    float32 scores; a failed or timed-out batch raises."""
    return device_call(_pwm_scores_device, rows, wpwm, den, _device(),
                       what="stage-4 PWM device batch")


def _pwm_scores_device(rows: np.ndarray, wpwm: np.ndarray, den: float,
                       device) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.int8)
    wpwm = np.ascontiguousarray(wpwm, dtype=np.float32)
    tally(pwm_windows=rows.shape[0])
    r = service_eval("pwm", (rows, wpwm, float(den)), device)
    if r is not None:
        tally(batches=1)
        return r
    device = _local(device)
    with timing.span("pintron_pwm"):
        scores = pwm_scores_cuda(torch.from_numpy(rows).to(device),
                                 torch.from_numpy(wpwm).to(device),
                                 float(den))
        tally(batches=1)
        return scores.cpu().numpy()

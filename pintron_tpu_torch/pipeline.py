"""Pipeline CLI of the port (``python -m pintron_tpu_torch.pipeline``).

The counterpart of ``pintron_tpu.pipeline``, with the same flags plus
``--device``.  With a device:

  * STEP 2 (est-fact) runs the port's ``run_est_fact`` there, in this
    process: a CUDA context must never be created in a forked child, so
    the device stages are not run under the fork watchdog;
  * STEP 3 (exon agreement) runs ``pintron_tpu``'s host stage in a
    forked child under its resource guard (``--set-max-exon-agreement-
    time``), as ``pintron_tpu.pipeline`` runs it;
  * STEP 4 (intron agreement) runs the port's ``run_intron_agreement``
    on the device, in this process;
  * STEPs 5-8 and the cleanup are ``pintron_tpu.pipeline.
    pintron_pipeline`` itself, entered with resume on so that it finds
    the outputs of STEPs 2-4 and runs the rest on its host paths.

Without a device the whole run is ``pintron_tpu``'s host path.  With
``PINTRON_TORCH_SERVICE`` set (the batch driver sets it), the device
batches of STEPs 2 and 4 go to the device service instead, and this
process never touches CUDA.

``PINTRON_TORCH_PROFILE=<dir>`` writes a ``torch.profiler`` trace of
the whole pipeline there; the device batches carry the spans
``pintron_kband_full``, ``pintron_kband_band``, ``pintron_nw``,
``pintron_gap``, ``pintron_rowmin``, ``pintron_edit`` and
``pintron_pwm``.  STEP 2 logs one line, ``est-fact device flow:
{...}``, with the offload counters per family, the kernel launches, the
host DP cells by family and the device share of the DP cells; STEP 4
logs ``intron-agreement device flow: {...}``.
"""

from __future__ import annotations

import argparse
import inspect
import logging
import os
import shutil
import sys
import time

from pintron_tpu import pipeline as _host

STEP2_ARTIFACTS = ("raw-multifasta-out.txt", "processed-ests.txt")
STEP3_ARTIFACTS = ("out-agree.txt",)
STEP4_ARTIFACTS = ("out-after-intron-agree.txt", "predicted-introns.txt")
# what pintron_tpu's STEPs 5-7 leave behind; a run without --resume
# removes them, so that the host orchestrator skips STEPs 2-4 alone
LATER_ARTIFACTS = ("build-ests.txt", "genomic-exonforCCDS.txt",
                   "isoforms.txt", "CCDS_transcripts.txt", "VariantGTF.txt")


def _start_profiler():
    prof_dir = os.environ.get("PINTRON_TORCH_PROFILE")
    if not prof_dir:
        return None, None
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # the device batches run on dispatch threads, which the profiler's
    # CPU trace follows only when asked to
    prof = torch.profiler.profile(
        activities=acts,
        experimental_config=torch.profiler._ExperimentalConfig(
            profile_all_threads=True))
    prof.start()
    return prof, prof_dir


def _run_guarded(fn, minutes: int, artifacts) -> None:
    """``pintron_tpu.pipeline``'s resource guard for a host stage
    (reference pintron.py:878-906 ``ulimit -t``): run ``fn`` in a forked
    child with RLIMIT_CPU and a wall-clock watchdog, and remove the
    stage's ``artifacts`` when it fails or times out, so that a later
    --resume cannot pick up a truncated file.  ``minutes <= 0`` runs it
    inline.  The child touches no CUDA."""
    if minutes <= 0:
        fn()
        return
    import multiprocessing

    def child():
        import resource
        cpu = minutes * 60
        try:
            resource.setrlimit(resource.RLIMIT_CPU, (cpu, cpu + 10))
        except (ValueError, OSError):
            pass
        fn()

    proc = multiprocessing.get_context("fork").Process(target=child)
    proc.start()
    proc.join(timeout=minutes * 60 + 30)
    timed_out = proc.is_alive()
    if timed_out:
        proc.terminate()
        proc.join(timeout=10)
    if timed_out or proc.exitcode != 0:
        for path in artifacts:
            try:
                os.remove(path)
            except OSError:
                pass
        raise RuntimeError(
            "stage exceeded its resource guard or failed "
            + ("(wall-clock timeout)" if timed_out
               else f"(exit {proc.exitcode})"))


def pintron_pipeline(workdir: str = ".", device=None, **kwargs) -> None:
    """Run the eight pipeline steps over ``workdir``.  ``device`` is the
    torch device of the batches of STEPs 2 and 4 (``None``: host only);
    the other arguments are ``pintron_tpu.pipeline.pintron_pipeline``'s."""
    for var, use in (("PINTRON_DEVICE", "--device"),
                     ("PINTRON_JAX_PROFILE", "PINTRON_TORCH_PROFILE")):
        if os.environ.get(var):
            raise RuntimeError(f"{var} is set: pintron_tpu would import "
                               f"JAX.  Unset it; the port uses {use}")
    call = inspect.signature(_host.pintron_pipeline).bind(workdir, **kwargs)
    call.apply_defaults()
    a = call.arguments
    if device is None:
        _host.pintron_pipeline(**a)
        return
    from pintron_tpu.stages.min_factorization import run_min_factorization
    from pintron_tpu_torch.stages.est_fact import run_est_fact
    from pintron_tpu_torch.stages.intron_agreement import \
        run_intron_agreement

    def wpath(name: str) -> str:
        return os.path.join(workdir, name)

    def run_step(label: str, artifacts, fn) -> None:
        """Run one step, or skip it under --resume when its artifacts
        exist; the -l/--logfile record pintron_tpu keeps for its own
        steps (begin, then ok or FAILED with the wall time)."""
        if a["resume"] and all(os.path.exists(wpath(n)) for n in artifacts):
            log.info("%s [resume] outputs found, skipping", label)
            return
        log.info("%s on %s...", label, device)

        def plog(msg):
            if a["pipeline_logfile"]:
                with open(wpath(a["pipeline_logfile"]), "a") as f:
                    f.write(f"[{label}] {msg}\n")

        plog("begin")
        t = time.time()
        try:
            fn()
        except BaseException as e:
            plog(f"FAILED after {time.time() - t:.1f}s: "
                 f"{type(e).__name__}: {e}")
            raise
        plog(f"ok ({time.time() - t:.1f}s)")

    def step3():
        with open(wpath("raw-multifasta-out.txt")) as fin, \
                open(wpath("out-agree.txt"), "w") as fout:
            run_min_factorization(fin, fout)

    log = a["log"]
    prof, prof_dir = _start_profiler()
    # STEP 1: input checks; the stage ABI uses the well-known names
    for f, name in ((a["genome_filename"], "genomic.txt"),
                    (a["est_filename"], "ests.txt")):
        if not os.access(wpath(f), os.R_OK):
            raise FileNotFoundError(wpath(f))
        if f != name:
            shutil.copyfile(wpath(f), wpath(name))
    if not a["resume"]:
        for name in LATER_ARTIFACTS:
            if os.path.exists(wpath(name)):
                os.remove(wpath(name))

    run_step("cmd-2-est-fact", STEP2_ARTIFACTS,
             lambda: run_est_fact(workdir, config=a["config"],
                                  device=device))
    run_step("cmd-3-min-factorization", STEP3_ARTIFACTS,
             lambda: _run_guarded(step3, a["max_exon_agreement_time"],
                                  [wpath(n) for n in STEP3_ARTIFACTS]))
    run_step("cmd-4-intron-agreement", STEP4_ARTIFACTS,
             lambda: run_intron_agreement(workdir, device=device))

    log.info("STEPs 5-8 on pintron_tpu's host paths")
    _host.pintron_pipeline(**dict(a, resume=True))
    if prof is not None:
        prof.stop()
        os.makedirs(prof_dir, exist_ok=True)
        trace = os.path.join(prof_dir, f"pintron-{os.getpid()}.json")
        prof.export_chrome_trace(trace)
        log.info("torch profiler trace written to %s", trace)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pintron-tpu-torch",
        description="PIntron on PyTorch/CUDA: gene-structure prediction "
                    "by spliced alignment of ESTs/mRNAs")
    p.add_argument("--device", default=None,
                   help="torch device of the batches of STEPs 2 and 4 "
                        "(cuda, cuda:N or cpu); default: host only")
    p.add_argument("-g", "--genomic", dest="genome_filename",
                   default="genomic.txt")
    p.add_argument("-s", "--EST", dest="est_filename", default="ests.txt")
    p.add_argument("-o", "--output", dest="output_filename",
                   default="pintron-full-output.json")
    p.add_argument("-t", "--gtf", dest="gtf_filename",
                   default="pintron-all-isoforms.gtf")
    p.add_argument("--extended-gtf", dest="extended_gtf", default=None)
    p.add_argument("--strict-GTF-compliance", dest="only_cds_annot",
                   action="store_true", default=False)
    p.add_argument("-e", "--gene", dest="gene", default="unknown")
    p.add_argument("-n", "--organism", dest="organism", default="unknown")
    p.add_argument("-k", "--keep-intermediate-files", dest="no_clean",
                   action="store_true", default=False)
    p.add_argument("-l", "--logfile", dest="plogfile",
                   default="pintron-pipeline-log.txt")
    p.add_argument("--general-logfile", dest="glogfile",
                   default="pintron-log.txt")
    p.add_argument("-b", "--bin-dir", dest="bindir", default="")
    p.add_argument("-z", "--compress", dest="compress", action="store_true",
                   default=False)
    p.add_argument("--pas-tolerance", dest="pas_tolerance", type=int,
                   default=30)
    p.add_argument("--set-max-factorization-time", type=int, default=60)
    p.add_argument("--set-max-factorization-memory", type=int, default=3000)
    p.add_argument("--set-max-exon-agreement-time", type=int, default=15)
    p.add_argument("--set-max-intron-agreement-time", type=int, default=30)
    p.add_argument("--workdir", default=".")
    p.add_argument("--resume", action="store_true",
                   help="skip stages whose output artifacts already "
                        "exist (the inter-stage files are idempotent "
                        "checkpoints)")
    args = p.parse_args(argv)

    # dual-sink logging (reference pintron.py:986-1002 prepare_loggers):
    # DEBUG+ to --general-logfile, INFO+ to the console
    glogfile = args.glogfile
    if glogfile and not os.path.isabs(glogfile):
        glogfile = os.path.join(args.workdir, glogfile)
    root = logging.getLogger("")
    root.setLevel(logging.DEBUG)
    if glogfile:
        fh = logging.FileHandler(glogfile, mode="w")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(
            "%(levelname)s:%(name)s:%(asctime)s%(msecs)d:%(message)s",
            datefmt="%Y%m%d-%H%M%S"))
        root.addHandler(fh)
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter(
        "[%(levelname)-8s] %(asctime)s - %(message)s"))
    root.addHandler(console)

    if args.bindir:
        logging.getLogger("pintron").warning(
            "--bin-dir=%s ignored: all pipeline stages are built in",
            args.bindir)

    pintron_pipeline(
        workdir=args.workdir,
        genome_filename=args.genome_filename,
        est_filename=args.est_filename,
        output_filename=args.output_filename,
        gtf_filename=args.gtf_filename,
        gene=args.gene,
        organism=args.organism,
        only_cds_annot=args.only_cds_annot,
        extended_gtf_filename=args.extended_gtf or "",
        pipeline_logfile=args.plogfile or "",
        pas_tolerance=args.pas_tolerance,
        keep_intermediate=args.no_clean,
        resume=args.resume,
        max_factorization_time=args.set_max_factorization_time,
        max_factorization_memory=args.set_max_factorization_memory,
        max_exon_agreement_time=args.set_max_exon_agreement_time,
        max_intron_agreement_time=args.set_max_intron_agreement_time,
        device=args.device,
    )
    if args.compress:
        # reference pintron.py:965-972 gzips the JSON and both logfiles
        import gzip
        for src in (os.path.join(args.workdir, args.output_filename),
                    os.path.join(args.workdir, args.plogfile)
                    if args.plogfile and not os.path.isabs(args.plogfile)
                    else args.plogfile,
                    glogfile):
            if not src or not os.path.exists(src):
                continue
            with open(src, "rb") as fi, gzip.open(src + ".gz", "wb") as fo:
                shutil.copyfileobj(fi, fo)
            os.remove(src)
    return 0


if __name__ == "__main__":
    sys.exit(main())

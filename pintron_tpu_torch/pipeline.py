"""Pipeline orchestrator + CLI of the port
(`python -m pintron_tpu_torch.pipeline`).

Rebuild of the reference `pintron` driver (dist-scripts/pintron.py:764-1021):
runs the eight pipeline steps over a working directory, producing the
full-output JSON and GTF from `genomic.txt` + `ests.txt`.  Same flags,
same intermediate-file ABI, same cleanup list as
``pintron_tpu.pipeline``, plus ``--device``:

  * ``cuda`` (the default) or ``cuda:N``: the batches of STEP 2
    (est-fact) and STEP 4 (intron agreement) run on the card, in this
    process (a CUDA context must never be created in a forked child, so
    these two stages are not run under the fork watchdog; the per-EST
    timeout ladder bounds STEP 2 instead).  Raises without a card;
  * ``cpu``: the same with the plain PyTorch ops on the CPU;
  * ``host``: the native host path with no device batch, every guarded
    stage in its forked child, as the JAX package runs by default.

STEP 3 and STEPs 5-8 are host stages and run the same way in every
mode; STEP 3's guarded child comes from the guard server
(``guard.py``), started at a process's first pipeline call.  With
``PINTRON_TORCH_SERVICE`` set (``batch.py`` sets it), the device
batches of STEPs 2 and 4 go to the device service instead, and this
process never touches CUDA.

``PINTRON_TORCH_PROFILE=<dir>`` writes a ``torch.profiler`` trace of
the whole pipeline there (``pintron-<pid>.json``), and the spans the
recorder kept (``runtime/timing.py``; STEP 3's child's and STEP 2's
fork workers' included) beside it as ``spans-<pid>.jsonl``.  A locus is
one ``pintron_locus`` span (attrs: gene, records) over ``pintron_step1``
... ``pintron_step8``, ``pintron_gtf`` and ``pintron_cleanup``; a
process's first locus is preceded by ``pintron_startup`` (attrs:
package_s, pid), from the process's start to the locus's; a forked
stage's child opens ``pintron_step<n>_child``; the device batches carry
the spans ``pintron_kband_full``, ``pintron_kband_band``,
``pintron_nw``, ``pintron_gap``, ``pintron_rowmin``, ``pintron_edit``
and ``pintron_pwm``, each from its launches to its results read back
(PERF.md lists every span and what reads it).  STEP 2 logs one
line, ``est-fact device flow: {...}``, with the offload counters per
family, the kernel launches, the host DP cells by family and the device
share of the DP cells; STEP 4 logs ``intron-agreement device flow:
{...}``.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import shutil
import sys
import time

import torch

from pintron_tpu_torch import guard
from pintron_tpu_torch.runtime import timing


def _start_profiler():
    prof_dir = os.environ.get(timing.PROFILE_ENV)
    if not prof_dir:
        return None, None
    timing.trace_on()
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


# STEP 10's cleanup list (pintron.py:974-983)
TEMPFILES = (
    "TEMP_COMPOSITION_TRANS1_1.txt", "TEMP_COMPOSITION_TRANS1_2.txt",
    "TEMP_COMPOSITION_TRANS1_3.txt", "TEMP_COMPOSITION_TRANS1_4.txt",
    "TRANSCRIPTS1_1.txt", "TRANSCRIPTS1_2.txt", "TRANSCRIPTS1_3.txt",
    "TRANSCRIPTS1_4.txt", "VariantGTF.txt", "build-ests.txt",
    "CCDS_transcripts.txt", "config-dump.ini",
    "genomic-exonforCCDS.txt", "isoforms.txt", "meg-edges.txt",
    "megs.txt", "out-after-intron-agree.txt", "out-agree.txt",
    "out-fatt.txt", "predicted-introns.txt", "processed-ests.txt",
    "processed-megs-info.txt", "processed-megs.txt",
    "raw-multifasta-out.txt", "time-limits", "info-pid-*.log",
)


def pintron_pipeline(workdir: str = ".",
                     genome_filename: str = "genomic.txt",
                     est_filename: str = "ests.txt",
                     output_filename: str = "pintron-full-output.json",
                     gtf_filename: str = "pintron-all-isoforms.gtf",
                     gene: str = "unknown",
                     organism: str = "unknown",
                     only_cds_annot: bool = False,
                     extended_gtf_filename: str = "",
                     pipeline_logfile: str = "",
                     pas_tolerance: int = 30,
                     keep_intermediate: bool = False,
                     resume: bool = False,
                     max_factorization_time: int = 60,
                     max_factorization_memory: int = 3000,
                     max_exon_agreement_time: int = 15,
                     max_intron_agreement_time: int = 30,
                     config=None,
                     log=logging.getLogger("pintron"),
                     device="cuda") -> None:
    """Run the eight pipeline steps over ``workdir``.  ``device`` is
    ``"cuda"`` (the default), ``"cuda:N"``, ``"cpu"`` or ``"host"`` (see
    the module docstring); the device is checked before any step runs,
    so ``"cuda"`` without a card raises at once."""
    for var, use in (("PINTRON_DEVICE", "device"),
                     ("PINTRON_JAX_PROFILE", "PINTRON_TORCH_PROFILE")):
        if os.environ.get(var):
            raise RuntimeError(f"{var} is set: it is the JAX package's "
                               f"switch.  Unset it; the port uses {use}")
    from pintron_tpu_torch.ops import offload
    from pintron_tpu_torch.stages import est_fact, intron_agreement
    from pintron_tpu_torch.stages.min_factorization import \
        run_min_factorization_files
    from pintron_tpu_torch.stages.compact import run_compact_compositions
    from pintron_tpu_torch.stages.transcripts import run_maximal_transcripts
    from pintron_tpu_torch.stages.ccds import run_cds_annotation
    from pintron_tpu_torch.stages.emit import compute_json, json2gtf

    host = offload.is_host(device)
    if not host:
        device = offload.use_device(device)

    def wpath(name: str) -> str:
        return os.path.join(workdir, name)

    # -l/--logfile: the per-step pipeline log (reference pintron.py's
    # exec_system_command appends each stage's label, command analogue
    # and exit status to options.plogfile via `2>> logfile`).  The
    # stages here run in-process, so the equivalent record is a
    # begin/end line per step with wall time and outcome.
    _plog_path = None
    if pipeline_logfile:
        _plog_path = (pipeline_logfile if os.path.isabs(pipeline_logfile)
                      else wpath(pipeline_logfile))

    def plog(label: str, msg: str) -> None:
        if _plog_path is not None:
            with open(_plog_path, "a") as f:
                f.write(f"[{label}] {msg}\n")

    def run_step(label: str, fn) -> None:
        plog(label, "begin")
        t = time.time()
        try:
            fn()
        except BaseException as e:
            plog(label, f"FAILED after {time.time() - t:.1f}s: "
                        f"{type(e).__name__}: {e}")
            raise
        plog(label, f"ok ({time.time() - t:.1f}s)")

    def run_guarded(step: int, fn, minutes: int, mem_mb: int = 0,
                    artifacts: tuple = (), device_stage: bool = False,
                    served=None):
        """Resource guards (reference pintron.py:878-906 `ulimit -t/-v`):
        run the stage in a child process with RLIMIT_CPU of ``minutes``
        and RLIMIT_AS growth of ``mem_mb``, and a wall-clock watchdog of
        ``minutes`` plus 30 s in this process (a child that forks pool
        workers cannot see their CPU in its own rlimit), so that a
        runaway stage aborts the pipeline instead of hanging it.  On
        failure the stage's declared output artifacts are removed so a
        later --resume cannot pick up a truncated checkpoint.  The
        stages communicate through files, so process isolation changes
        nothing on success.  Guards <= 0 run the stage inline.

        Where the child comes from (``guard.py``): STEP 3 names its call
        (``served``), and the guard server forks it, a small process
        started by exec at this process's first pipeline call that
        never imports torch, so a locus no longer pays a fork of this
        process, which maps torch and the CUDA context.  ``--device
        host``'s STEPs 2 and 4 keep a fork of this process: their
        modules import torch at the top, and a torch import in each
        child would cost more than the fork it saves.  With a torch
        device those two stages (device_stage=True) run inline, as a
        CUDA context cannot be used in a forked child, relying on the
        per-EST timeout ladder instead.  Spans: ``pintron_fork``
        (processes, via) over the request or the fork,
        ``pintron_fork_wait`` over the wait and join, and the child's
        ``pintron_step<step>_child`` under the first."""
        if minutes <= 0 or (device_stage and not host):
            fn()
            return
        guard.run_guarded(step, fn, minutes * 60, minutes * 60 + 30,
                          mem_mb, tuple(wpath(a) for a in artifacts),
                          served)

    def stage_done(*artifacts: str) -> bool:
        """Idempotent restart: the inter-stage files double as
        checkpoints (SURVEY §5 / reference DESIGN.md) -- with --resume a
        stage whose outputs already exist is skipped."""
        return resume and all(os.path.exists(wpath(a)) for a in artifacts)

    t0 = time.time()
    # STEP 3's guard server starts now, its start overlapping STEPs 1-2
    guard.start()
    # PINTRON_TORCH_PROFILE=<dir>: a torch.profiler trace of the whole
    # pipeline, and the recorder's spans beside it
    prof, prof_dir = _start_profiler()
    with timing.timed_span("pintron_locus", gene=gene) as locus:
        # a process's first locus: its start-up, process start to here
        timing.startup(locus.start)
        with timing.span("pintron_step1"):
            # STEP 1: input checks (pintron.py:824-873)
            log.info("STEP  1:  Checking executables and input files...")
            for f in (genome_filename, est_filename):
                if not os.access(wpath(f), os.R_OK):
                    raise FileNotFoundError(wpath(f))
            if timing.recording():
                with open(wpath(est_filename), "rb") as fh:
                    locus.attrs["records"] = sum(
                        1 for line in fh if line.startswith(b">"))

            # the stage ABI uses the well-known names; stage inputs may be
            # aliased
            if genome_filename != "genomic.txt":
                shutil.copyfile(wpath(genome_filename), wpath("genomic.txt"))
            if est_filename != "ests.txt":
                shutil.copyfile(wpath(est_filename), wpath("ests.txt"))

        # STEP 2: spliced alignment (est-fact)
        with timing.span("pintron_step2"):
            if stage_done("raw-multifasta-out.txt", "processed-ests.txt"):
                log.info("STEP  2:  [resume] spliced alignments found, "
                         "skipping")
            else:
                log.info("STEP  2:  Computing the spliced alignments...")
                run_step("cmd-2-est-fact", lambda: run_guarded(
                    2, lambda: est_fact.run_est_fact(workdir, config=config,
                                                     device=device),
                    max_factorization_time, max_factorization_memory,
                    artifacts=("raw-multifasta-out.txt",
                               "processed-ests.txt", "megs.txt",
                               "processed-megs.txt", "meg-edges.txt",
                               "processed-megs-info.txt"),
                    device_stage=True))

        # STEP 3: minimum-factorization agreement
        with timing.span("pintron_step3"):
            if stage_done("out-agree.txt"):
                log.info("STEP  3:  [resume] agreement found, skipping")
            else:
                log.info("STEP  3:  Computing the agreement of the "
                         "alignments...")

                step3 = (os.path.abspath(wpath("raw-multifasta-out.txt")),
                         os.path.abspath(wpath("out-agree.txt")))
                run_step("cmd-3-min-factorization", lambda: run_guarded(
                    3, lambda: run_min_factorization_files(*step3),
                    max_exon_agreement_time, artifacts=("out-agree.txt",),
                    served=("pintron_tpu_torch.stages.min_factorization",
                            "run_min_factorization_files", step3)))

        # STEP 4: intron agreement + classification
        with timing.span("pintron_step4"):
            if stage_done("out-after-intron-agree.txt",
                          "predicted-introns.txt"):
                log.info("STEP  4:  [resume] intron agreement found, skipping")
            else:
                log.info("STEP  4:  Computing the intron agreement...")
                run_step("cmd-4-intron-agreement", lambda: run_guarded(
                    4, lambda: intron_agreement.run_intron_agreement(
                        workdir, device=device),
                    max_intron_agreement_time,
                    artifacts=("out-after-intron-agree.txt",
                               "predicted-introns.txt"),
                    device_stage=True))

        # STEP 5: composition compaction
        with timing.span("pintron_step5"):
            if stage_done("build-ests.txt", "genomic-exonforCCDS.txt"):
                log.info("STEP  5:  [resume] compacted compositions found, "
                         "skipping")
            else:
                log.info("STEP  5:  Computing the final transcript "
                         "alignments...")

                def _step5():
                    with open(wpath("out-after-intron-agree.txt")) as fin, \
                            open(wpath("build-ests.txt"), "w") as fout:
                        run_compact_compositions(
                            fin, fout, wpath("genomic.txt"),
                            wpath("genomic-exonforCCDS.txt"))

                run_step("cmd-5-compact-compositions", _step5)

        # STEP 6: maximal transcripts
        with timing.span("pintron_step6"):
            if stage_done("isoforms.txt"):
                log.info("STEP  6:  [resume] isoforms found, skipping")
            else:
                log.info("STEP  6:  Computing the final full-length "
                         "isoforms...")

                def _step6():
                    run_maximal_transcripts(workdir)
                    shutil.copyfile(wpath("TRANSCRIPTS1_1.txt"),
                                    wpath("isoforms.txt"))

                run_step("cmd-6a-maximal-transcripts", _step6)

        # STEP 7: CDS annotation
        with timing.span("pintron_step7"):
            if stage_done("CCDS_transcripts.txt", "VariantGTF.txt"):
                log.info("STEP  7:  [resume] CDS annotation found, skipping")
            else:
                log.info("STEP  7:  Annotating CDS...")
                run_step("cmd-7-cds-annotation",
                         lambda: run_cds_annotation(workdir, gene=gene,
                                                    organism=organism))

        # STEP 8: JSON + GTF emission
        with timing.span("pintron_step8"):
            log.info("STEP  8:  Saving outputs...")
            run_step("cmd-8-compute-json",
                     lambda: compute_json(workdir, wpath(output_filename),
                                          pas_tolerance=pas_tolerance))
        with timing.span("pintron_gtf"):
            if gtf_filename:
                json2gtf(wpath(output_filename), wpath(gtf_filename), gene,
                         not only_cds_annot)
            if extended_gtf_filename:
                # --extended-gtf: an always-complete GTF variant (every
                # isoform with full exon/UTR/codon rows) alongside the main
                # one — under --strict-GTF-compliance the main GTF is
                # restricted to CDS-annotated isoforms (reference
                # pintron.py:232-273), and this file preserves the
                # unrestricted view
                json2gtf(wpath(output_filename),
                         wpath(extended_gtf_filename), gene, True)

        # STEP 10: cleanup (pintron.py:974-983)
        with timing.span("pintron_cleanup"):
            log.info("STEP 10:  Finalizing...")
            if not keep_intermediate:
                for name in TEMPFILES:
                    for p in glob.glob(wpath(name)):
                        try:
                            os.remove(p)
                        except OSError:
                            pass

    if prof is not None:
        prof.stop()
        os.makedirs(prof_dir, exist_ok=True)
        trace = os.path.join(prof_dir, f"pintron-{os.getpid()}.json")
        prof.export_chrome_trace(trace)
        spans = timing.write_spans(prof_dir, timing.trace_take())
        timing.trace_off()
        log.info("torch profiler trace written to %s, spans to %s", trace,
                 spans)
    log.info("Pipeline completed in %.1fs", time.time() - t0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pintron-tpu-torch",
        description="PIntron on PyTorch/CUDA: gene-structure prediction "
                    "by spliced alignment of ESTs/mRNAs")
    p.add_argument("--device", default="cuda",
                   help="where the batches of STEPs 2 and 4 run: cuda "
                        "(default), cuda:N, cpu (the plain PyTorch ops) or "
                        "host (the native host path, no device batch)")
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
        # every stage is built into pintron_tpu_torch; there are no
        # external stage executables for --bin-dir to locate
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

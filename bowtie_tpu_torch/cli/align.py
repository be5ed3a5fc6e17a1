"""bowtie-compatible alignment CLI (option surface of ebwt_search.cpp:332-428).

Usage: python -m bowtie_tpu_torch.cli.align [options] <ebwt-base> <reads> [<hits>]

This port runs the exact-match mode (-v 0), the mismatch modes -v 1 and
-v 2 (the GreedyDFS machine, align/dfs_device.py), bowtie's default
seeded mode -n 0..3 (two launches of that machine, align/n_device.py)
and the best-first engine for --best, --strata, -M and -v 3 (the
best-first machine, align/best_device.py) with -k/-a/-m reporting on the
CUDA kernels, with --sanity, --stats and -p for the host engines.  Paired
input (-1/-2, --12, --interleaved) runs the V1 engine with its anchor
streams recorded on the card (align/pe_device.py); --best and --pev2 run
the V2 engine with its merged stream recorded on the card
(align/pev2_device.py), --reportse the V2 host engine and --nofw/--norc
the V1 host engine (align/best_paired.py).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from ..align.best_device import DeviceBestAligner
from ..align.best_driver import UnpairedBestAligner
from ..align.best_factories import (make_best_aligner,
                                    make_paired_best_aligner,
                                    make_paired_best_aligner_v2,
                                    make_seeded_best_aligner)
from ..align.best_paired import PairedBestAligner, PairedBestAlignerV2
from ..align.dfs_device import FALLBACKS, DeviceDFSAligner
from ..align.drivers import OracleAligner
from ..align.golden import GoldenFM
from ..align.n_device import DeviceNAligner
from ..align.parallel_host import ParallelHostAligner
from ..align.pe_device import DevicePairedBestAligner
from ..align.pev2_device import DevicePairedV2Aligner
from ..align.pipeline import ExactAligner
from ..align.policy import INF, AlignStats, KPolicy
from ..index.arrays import from_ebwt
from ..index.ebwt_io import (index_paths, read_bitpair_reference, read_ebwt,
                             unpack_reference)
from ..io.readers import PairedReadSource, ReadSource
from ..io.sam import SamWriter
from ..io.verbose import VerboseWriter
from ..utils.device import resolve_device
from ..utils.metrics import AlignerMetrics


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bowtie-tpu-torch",
        description="ultrafast short-read aligner on CUDA "
                    "(bowtie-1-compatible)")
    p.add_argument("-x", dest="index_opt", default=None,
                   help="index basename (positional form deprecated)")
    p.add_argument("ebwt_base", nargs="?", default=None)
    p.add_argument("reads", nargs="?", default=None)
    p.add_argument("hits", nargs="?", default=None)
    # paired-end input
    p.add_argument("-1", dest="mates1", default=None)
    p.add_argument("-2", dest="mates2", default=None)
    p.add_argument("--12", dest="tabbed", default=None)
    p.add_argument("--interleaved", default=None)
    p.add_argument("-I", "--minins", type=int, default=0)
    p.add_argument("-X", "--maxins", type=int, default=250)
    p.add_argument("--ff", action="store_true")
    p.add_argument("--rf", action="store_true")
    p.add_argument("--fr", action="store_true", default=True)
    p.add_argument("--pairtries", type=int, default=100)
    p.add_argument("--allow-contain", action="store_true")
    # input
    p.add_argument("-q", dest="fastq", action="store_true", default=True)
    p.add_argument("-f", dest="fasta", action="store_true")
    p.add_argument("-r", dest="raw", action="store_true")
    p.add_argument("-c", dest="cmdline", action="store_true")
    p.add_argument("-F", dest="fasta_cont", default=None, metavar="k,i")
    p.add_argument("-s", "--skip", type=int, default=0)
    p.add_argument("-u", "--qupto", type=int, default=None)
    p.add_argument("-5", "--trim5", type=int, default=0)
    p.add_argument("-3", "--trim3", type=int, default=0)
    p.add_argument("--phred33-quals", action="store_true", default=True)
    p.add_argument("--phred64-quals", action="store_true", default=False)
    p.add_argument("--solexa-quals", action="store_true", default=False)
    p.add_argument("--solexa1.3-quals", dest="solexa13", action="store_true")
    p.add_argument("--integer-quals", action="store_true", default=False)
    # alignment policy
    p.add_argument("-v", dest="mismatches", type=int, default=-1)
    p.add_argument("-n", "--seedmms", type=int, default=2)
    p.add_argument("-e", "--maqerr", type=int, default=70)
    p.add_argument("-l", "--seedlen", type=int, default=28)
    p.add_argument("--nomaqround", action="store_true")
    p.add_argument("--nofw", action="store_true")
    p.add_argument("--norc", action="store_true")
    p.add_argument("--maxbts", type=int, default=None)
    p.add_argument("-y", "--tryhard", action="store_true")
    # reporting
    p.add_argument("-k", dest="khits", type=int, default=1)
    p.add_argument("-a", "--all", action="store_true")
    p.add_argument("-m", dest="mhits", type=int, default=None)
    p.add_argument("-M", dest="sample_mhits", type=int, default=None)
    p.add_argument("--best", action="store_true")
    p.add_argument("--strata", action="store_true")
    # output
    p.add_argument("-S", "--sam", action="store_true")
    p.add_argument("--mapq", type=int, default=255)
    p.add_argument("--sam-nohead", action="store_true")
    p.add_argument("--sam-nosq", action="store_true")
    p.add_argument("--sam-RG", action="append", default=None,
                   help="field for the @RG header; repeatable, fields "
                        "joined with tabs (ebwt_search.cpp:791-795)")
    p.add_argument("--fullref", action="store_true")
    p.add_argument("--no-qname-trunc", action="store_true")
    p.add_argument("--refidx", action="store_true")
    p.add_argument("-B", "--offbase", type=int, default=0)
    p.add_argument("--suppress", default=None)
    p.add_argument("--cost", action="store_true")
    p.add_argument("--showseed", action="store_true")
    p.add_argument("--partition", type=int, default=0)
    p.add_argument("--un", default=None)
    p.add_argument("--al", default=None)
    p.add_argument("--max", dest="maxfile", default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("-t", "--time", action="store_true")
    # performance
    p.add_argument("-p", "--threads", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=8192,
                   help="reads per device batch")
    p.add_argument("--reads-per-batch", type=int, default=None,
                   help="alias of --batch-size (bowtie compat)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--stats", action="store_true",
                   help="print aligner metrics (AlignerMetrics analog)")
    # accepted-for-compatibility flags (no-ops in this architecture;
    # single-stream batched output is already deterministic, and the
    # index lives in device memory rather than mmap/SysV shm)
    p.add_argument("--reorder", action="store_true")
    p.add_argument("--mm", action="store_true")
    p.add_argument("--shmem", action="store_true")
    p.add_argument("--mmsweep", action="store_true")
    p.add_argument("--chunkmbs", type=int, default=64)
    p.add_argument("--pairtries-unused", dest="_pt", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--prewidth", type=int, default=1)
    p.add_argument("--large-index", action="store_true",
                   help="prefer the .ebwtl variant if both exist")
    p.add_argument("-o", "--offrate", type=int, default=-1,
                   help="re-thin the SA sample at load (must be >= the"
                        " index's offrate; ebwt.h:438-441)")
    p.add_argument("--no-unal", action="store_true",
                   help="suppress SAM records for unaligned reads")
    p.add_argument("--version", action="store_true")
    p.add_argument("-Q", "--quals", default=None,
                   help="QV files (colorspace-era; ignored, like the "
                        "reference since colorspace removal in 1.3.0)")
    p.add_argument("--Q1", default=None, help=argparse.SUPPRESS)
    p.add_argument("--Q2", default=None, help=argparse.SUPPRESS)
    p.add_argument("--usage", action="help", help=argparse.SUPPRESS)
    # long aliases (getopt table, ebwt_search.cpp:332-428)
    p.add_argument("--khits", dest="khits", type=int)
    p.add_argument("--mhits", dest="mhits", type=int)
    p.add_argument("--sam-noSQ", dest="sam_nosq", action="store_true")
    p.add_argument("--sam-no-qname-trunc", dest="no_qname_trunc",
                   action="store_true")
    p.add_argument("--hadoopout", action="store_true",
                   help="Hadoop streaming counters on stderr "
                        "(hit.h:338-344)")
    # legacy/debug/perf-tuning flags accepted for compatibility; they
    # select internal strategies that have no analog (or are always-on)
    # in the batched architecture
    p.add_argument("--pev2", action="store_true",
                   help="use PairedBWAlignerV2 for paired-end")
    for flag in ("--filepar", "--noreconcile", "--strandfix",
                 "--better", "--oldbest", "--stateful", "--phased",
                 "--reportopps", "--sanity", "--startverbose",
                 "--chunkverbose", "--pause"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    for flag, dv in (("--cachelim", 0), ("--cachesz", 0),
                     ("--chunksz", 0), ("--isarate", -1),
                     ("--mixthresh", 4), ("--thread-ceiling", 0)):
        p.add_argument(flag, type=int, default=dv,
                       help=argparse.SUPPRESS)
    p.add_argument("--reportse", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--thread-piddir", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--orig", default=None, help=argparse.SUPPRESS)
    p.add_argument("--range", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--wrapper", default=None, help=argparse.SUPPRESS)
    return p


_IDX_CACHE: OrderedDict = OrderedDict()


def _index_key(base: str):
    f1, _f2, _ = index_paths(base)
    st = os.stat(f1)
    return (base, st.st_mtime_ns, st.st_size)


def read_ebwt_cached(base: str):
    """Process-level LRU of parsed indexes: repeated in-process CLI
    invocations (tests, library use, the -A argfile batch mode) skip
    the parse + side unpack.  Mutating callers must copy first."""
    key = _index_key(base)
    if key in _IDX_CACHE:
        _IDX_CACHE.move_to_end(key)
        return _IDX_CACHE[key]
    idx = read_ebwt(base)
    _IDX_CACHE[key] = idx
    while len(_IDX_CACHE) > 4:
        _IDX_CACHE.popitem(last=False)
    return idx


def adjust_ebwt_base(base: str) -> str:
    """Locate the index like adjustEbwtBase (ebwt.h:4397): try the
    given path, then $BOWTIE_INDEXES/<base>."""
    if os.path.exists(base + ".1.ebwt"):
        return base
    env = os.environ.get("BOWTIE_INDEXES")
    if env:
        cand = os.path.join(env, base)
        if os.path.exists(cand + ".1.ebwt"):
            return cand
    return base


@dataclass
class Part:
    """One process's part of a run whose reads are split over processes
    (parallel/launch.py).  Under -S only the first part writes the
    header, with the whole run's command line `cmdline`; no part prints
    the summary, and each leaves its counts in `stats` for the launcher to
    sum and print with print_summary."""
    cmdline: str
    first: bool
    stats: AlignStats | None = None


def main(argv=None, device=None, part: Part | None = None) -> int:
    """Run the aligner; `device` (default CUDA) is where the index lives
    and the kernels run — the tests pass "cpu" for the plain versions.
    `part` makes this run one part of a split run (Part)."""
    if "--version" in (argv if argv is not None else sys.argv[1:]):
        import platform
        print("bowtie-tpu-torch version 1.3.1-tpu-torch")
        print("64-bit")
        print(f"Python {platform.python_version()}")
        return 0
    args = build_parser().parse_args(argv)

    # index via -x or positional (ebwt_search.cpp:3358-3393: the
    # positional form is accepted with a deprecation warning; with -x
    # the positionals shift left to [query, output])
    if args.index_opt is not None:
        args.hits = args.reads
        args.reads = args.ebwt_base
        args.ebwt_base = args.index_opt
    else:
        if args.ebwt_base is None:
            print("No index, query, or output file specified!",
                  file=sys.stderr)
            return 1
        print("Setting the index via positional argument will be "
              "deprecated in a future release. Please use -x option "
              "instead.", file=sys.stderr)

    # arg validation (parseOptions, ebwt_search.cpp:614+)
    if args.mismatches >= 0 and not 0 <= args.mismatches <= 3:
        print("-v arg must be at least 0 and at most 3", file=sys.stderr)
        return 1
    if not 0 <= args.seedmms <= 3:
        print("-n arg must be at least 0 and at most 3", file=sys.stderr)
        return 1
    if args.strata and not args.best:
        print("--strata must be combined with --best", file=sys.stderr)
        return 1
    if args.strata and not (args.all or args.mhits is not None or
                            args.khits > 1 or
                            args.sample_mhits is not None):
        print("--strata has no effect unless combined with -m, -a, or "
              "-k N where N > 1", file=sys.stderr)
        return 1
    dev = resolve_device(device)

    fmt = "fastq"
    if args.fasta:
        fmt = "fasta"
    if args.raw:
        fmt = "raw"
    if args.cmdline:
        fmt = "cmdline"
    cont = None
    if args.fasta_cont:
        k, i = args.fasta_cont.split(",")
        fmt, cont = "fasta_cont", (int(k), int(i))

    t0 = time.time()
    args.ebwt_base = adjust_ebwt_base(args.ebwt_base)
    idx = read_ebwt_cached(args.ebwt_base)
    if args.offrate >= 0:
        # re-thin the SA sample at load (Ebwt ctor offRate override,
        # ebwt.h:438-441): keep every 2^(new-old)'th entry
        if args.offrate < idx.off_rate:
            print(f"Warning: -o/--offrate {args.offrate} is less than "
                  f"the index's offrate ({idx.off_rate}); ignoring",
                  file=sys.stderr)
        else:
            idx = idx.with_off_rate(args.offrate)   # the cache stays
    if args.time:
        print(f"Time loading ebwt: {time.time()-t0:.2f}s", file=sys.stderr)

    khits = args.khits
    mhits = args.mhits if args.mhits is not None else (
        args.sample_mhits if args.sample_mhits is not None else INF)
    if args.all:
        khits = INF
    policy = KPolicy(khits=khits, mhits=mhits,
                     sample_max=args.sample_mhits is not None)
    paired = _paired(args)
    aligner = build_aligner(args, idx, policy, dev)
    fallbacks = _fallback_counter(aligner)
    host_engine = isinstance(aligner, (UnpairedBestAligner, PairedBestAligner,
                                       PairedBestAlignerV2))
    if args.sanity and not host_engine and not paired:
        # a paired run gets no twin, as in bowtie_tpu/cli/align.py:485:
        # its recorded engine replays on the host engine already
        aligner = SanityAligner(
            aligner, build_aligner(args, idx, policy, dev, host_engine=True))
    if host_engine and args.threads > 1:
        # -p for the host engines: a fork pool over read-batch slices,
        # byte-identical output (align/parallel_host.py); the recorded
        # paired engine forks its own replay pool
        aligner = ParallelHostAligner(aligner, args.threads)
    try:
        return _run(args, argv, idx, policy, aligner, paired, fmt, cont,
                    fallbacks, dev, part)
    finally:
        # stop the fork pools of -p (ParallelHostAligner, the recorded
        # paired engine's replay pool)
        getattr(aligner, "close", lambda: None)()


def _paired(args) -> bool:
    """Paired input, as bowtie_tpu/cli/align.py:333 decides it (a lone -2
    is not)."""
    return bool(args.mates1 or args.tabbed or args.interleaved)


def _fallback_counter(aligner):
    """What --stats reports as fallbacks (bowtie_tpu/cli/align.py:914,
    919-920): a callable giving the reads the aligner re-ran on its host
    engine so far, or None for aligners without such re-runs (-v 0, the
    host engines)."""
    if isinstance(aligner, DeviceDFSAligner):
        f0 = FALLBACKS["lanes"]
        return lambda: FALLBACKS["lanes"] - f0
    if isinstance(aligner, (DeviceBestAligner, DevicePairedBestAligner,
                            DevicePairedV2Aligner)):
        return lambda: aligner.fallbacks
    return None


def _uses_best_first(args) -> bool:
    """bowtie forces its best-first engine for --best, --strata, -M and
    -v 3 (ebwt_search.cpp:852,877)."""
    return (args.best or args.strata or args.sample_mhits is not None
            or args.mismatches == 3)


def build_aligner(args, idx, policy, dev, host_engine: bool = False):
    """The aligner for the input and the mode flags: the paired one for
    paired input (_build_paired_aligner), else the single-end one."""
    if _paired(args):
        return _build_paired_aligner(args, idx, policy, dev, host_engine)
    return _build_se_aligner(args, idx, policy, dev, host_engine)


def _build_paired_aligner(args, idx, policy, dev, host_engine):
    """The paired aligner, chosen as bowtie_tpu/cli/align.py:333-420
    chooses it, with the recorded engine wherever that dispatch would take
    it on an accelerator: --best or --pev2 run the V2 engine with its
    merged stream recorded on the card (DevicePairedV2Aligner, K14), or
    under --reportse or on 2^31 rows or more the V2 host engine
    (make_paired_best_aligner_v2); otherwise, without --nofw/--norc and on
    fewer than 2^31 rows, the V1 engine with its anchor streams recorded
    on the card (DevicePairedBestAligner); otherwise the V1 host engine
    (make_paired_best_aligner).  With host_engine, the host engine of the
    same version stands in for the recorded one."""
    idx_bw = read_ebwt_cached(args.ebwt_base + ".rev")
    recs, packed = read_bitpair_reference(args.ebwt_base)
    refs = unpack_reference(recs, packed, plen=idx.plen)
    m1fw, m2fw = True, False          # --fr default
    if args.ff:
        m1fw, m2fw = True, True
    elif args.rf:
        m1fw, m2fw = False, True
    kw = dict(mode="n" if args.mismatches < 0 else "v",
              v=max(args.mismatches, 0), seed_mms=args.seedmms,
              seed_len=args.seedlen, qual_cutoff=args.maqerr, fw1=m1fw,
              fw2=m2fw, min_insert=args.minins, max_insert=args.maxins,
              pairtries=args.pairtries, maq=not args.nomaqround,
              better=args.best, global_seed=args.seed,
              maxbts=args.maxbts if args.maxbts is not None else 800)
    if args.best or args.pev2:
        # --reportse alone does not select V2: the reference then runs
        # V1, which ignores its SE sinks (aligner_0mm.h:309-321)
        if not (host_engine or args.reportse) and idx.length < (1 << 31):
            return DevicePairedV2Aligner(idx, idx_bw, refs, policy,
                                         nofw=args.nofw, norc=args.norc,
                                         best_sink=args.strata,
                                         threads=args.threads, device=dev,
                                         **kw)
        return make_paired_best_aligner_v2(
            GoldenFM(idx), GoldenFM(idx_bw), refs, policy, nofw=args.nofw,
            norc=args.norc, report_se=args.reportse,
            best_sink=args.strata, **kw)
    if not (host_engine or args.nofw or args.norc) and idx.length < (1 << 31):
        return DevicePairedBestAligner(idx, idx_bw, refs, policy,
                                       sym_ceiling=policy.max,
                                       threads=args.threads, device=dev,
                                       **kw)
    return make_paired_best_aligner(
        GoldenFM(idx), GoldenFM(idx_bw), refs, policy,
        sym_ceiling=policy.max, nofw=args.nofw, norc=args.norc, **kw)


def _build_stateful_se_aligner(args, idx, policy, dev):
    """The single-end aligner for the unpaired records of a --12 file
    (bowtie_tpu/cli/align.py:645-670): any paired input makes bowtie's
    whole run stateful (ebwt_search.cpp:3002), so they take the
    best-first engine with an NGood sink, whose draws decide them."""
    if _uses_best_first(args):
        return _build_se_aligner(args, idx, policy, dev, False)
    idx_bw = read_ebwt_cached(args.ebwt_base + ".rev")
    golden = (GoldenFM(idx), GoldenFM(idx_bw))
    kw = dict(strata=False, all_hits=args.all, nofw=args.nofw,
              norc=args.norc, maq=not args.nomaqround, global_seed=args.seed,
              maxbts=args.maxbts if args.maxbts is not None else 800)
    if args.mismatches >= 0:
        return make_best_aligner(*golden, args.mismatches, policy, **kw)
    return make_seeded_best_aligner(*golden, args.seedmms, args.seedlen,
                                    args.maqerr, policy, **kw)


def _build_se_aligner(args, idx, policy, dev, host_engine):
    """The single-end aligner for the mode flags, as the reference's
    dispatch builds it (bowtie_tpu/cli/align.py:510-642
    _build_se_aligner).  With host_engine, the aligner that dispatch
    builds with its host engine forced: the host best-first engine
    (make_best_aligner, make_seeded_best_aligner) for the best-first
    modes, the host oracle (OracleAligner) for -v 1/2 and -n, and for
    -v 0 a second ExactAligner, as there.  A best-first run on an index
    of 2^31 rows or more also gets its host engine, as there.  The mirror
    index is read as it is: -o re-thins only the forward one, as
    there."""
    if _uses_best_first(args):
        return _build_best_first(args, idx, policy, dev, host_engine)
    if args.mismatches == 0:
        return ExactAligner(from_ebwt(idx, device=dev), idx, policy,
                            nofw=args.nofw, norc=args.norc,
                            global_seed=args.seed)
    idx_bw = read_ebwt_cached(args.ebwt_base + ".rev")
    # -n's backtrack ceiling (bowtie_tpu/cli/align.py:622)
    n_kw = dict(seed_mms=args.seedmms, seed_len=args.seedlen,
                qual_thresh=args.maqerr,
                maxbts=args.maxbts if args.maxbts is not None else 125,
                maq_round=not args.nomaqround)
    common = dict(nofw=args.nofw, norc=args.norc, global_seed=args.seed)
    if host_engine:
        golden = (GoldenFM(idx), GoldenFM(idx_bw))
        if args.mismatches > 0:
            return OracleAligner(*golden, policy, v=args.mismatches,
                                 **common)
        return OracleAligner(*golden, policy, mode="n", **n_kw, **common)
    if args.mismatches > 0:
        return DeviceDFSAligner(idx, idx_bw, policy, v=args.mismatches,
                                device=dev, **common)
    return DeviceNAligner(idx, idx_bw, policy, device=dev, **n_kw, **common)


def _build_best_first(args, idx, policy, dev, host_engine):
    """The best-first aligner: -v's driver DAG when -v is given, else
    -n's seeded one (bowtie_tpu/cli/align.py:515-552, 578-618); the
    --maxbts default is 800 in both."""
    idx_bw = read_ebwt_cached(args.ebwt_base + ".rev")
    kw = dict(strata=args.strata, all_hits=args.all, nofw=args.nofw,
              norc=args.norc, maq=not args.nomaqround, global_seed=args.seed,
              maxbts=args.maxbts if args.maxbts is not None else 800)
    seeded = dict(seed_mms=args.seedmms, seed_len=args.seedlen,
                  qual_cutoff=args.maqerr)
    v_mode = args.mismatches >= 0
    if not host_engine:
        try:
            if v_mode:
                return DeviceBestAligner(idx, idx_bw, policy,
                                         v=args.mismatches, device=dev, **kw)
            return DeviceBestAligner(idx, idx_bw, policy, mode="n",
                                     device=dev, **seeded, **kw)
        except ValueError:
            pass                 # rows past int32: the host engine
    golden = (GoldenFM(idx), GoldenFM(idx_bw))
    if v_mode:
        return make_best_aligner(*golden, args.mismatches, policy, **kw)
    return make_seeded_best_aligner(*golden, seeded["seed_mms"],
                                    seeded["seed_len"],
                                    seeded["qual_cutoff"], policy, **kw)


class SanityAligner:
    """--sanity (bowtie_tpu/cli/align.py:442-474): align each batch with
    the aligner and with its host twin, and raise AssertionError, naming
    the read, at the first result that differs; return the aligner's
    results."""

    def __init__(self, dev, host):
        self._dev, self._host = dev, host

    @staticmethod
    def _key(r):
        return ([(h.fw, h.tidx, h.toff, h.oms, h.stratum, h.cost,
                  tuple(h.mms), h.mate) for h in r.hits],
                r.maxed, r.nvalid)

    def align_batch(self, reads):
        dev = self._dev.align_batch(reads)
        host = self._host.align_batch(reads)
        for read, dr, hr in zip(reads, dev, host):
            if self._key(dr) != self._key(hr):
                raise AssertionError(
                    f"--sanity: device/host divergence on read "
                    f"{read.name!r}: device={self._key(dr)} "
                    f"host={self._key(hr)}")
        return dev


def _run(args, argv, idx, policy, aligner, paired, fmt, cont, fallbacks,
         dev, part=None):
    dumps_active = bool(args.un or args.al or args.maxfile)
    qual_kw = dict(trim5=args.trim5, trim3=args.trim3,
                   solexa=args.solexa_quals,
                   phred64=args.phred64_quals or args.solexa13,
                   integer_quals=args.integer_quals, keep_orig=dumps_active)
    if paired:
        # the hits positional shifts left when the reads one is absent
        if args.reads and args.hits is None:
            args.hits = args.reads
        pe_kw = dict(upto=args.qupto, skip=args.skip, **qual_kw)
        if args.tabbed:
            src = PairedReadSource(args.tabbed.split(","), None, tabbed=True,
                                   **pe_kw)
        elif args.interleaved:
            src = PairedReadSource(args.interleaved.split(","), None,
                                   interleaved=True, **pe_kw)
        else:
            src = PairedReadSource(args.mates1.split(","),
                                   args.mates2.split(","), fmt=fmt, **pe_kw)
    else:
        src = ReadSource(
            paths=None if fmt == "cmdline" else args.reads.split(","),
            fmt=fmt, upto=args.qupto, skip=args.skip,
            cmdline_seqs=args.reads.split(",") if fmt == "cmdline" else None,
            cont_params=cont, **qual_kw)

    out = open(args.hits, "wb") if args.hits else sys.stdout.buffer
    refnames = ([str(i) for i in range(idx.npat)] if args.refidx
                else idx.refnames)
    if args.sam:
        # --refidx SAM keeps real names in @SQ but indices in records
        writer = SamWriter(out, idx.refnames, idx.plen.tolist(),
                           mapq=args.mapq, full_ref=args.fullref,
                           no_qname_trunc=args.no_qname_trunc,
                           sam_nohead=(args.sam_nohead or
                                       (part is not None and not part.first)),
                           sam_nosq=args.sam_nosq,
                           cmdline=(part.cmdline if part is not None else
                                    " ".join(argv or sys.argv[1:])),
                           rgline=("\t".join(args.sam_RG)
                                   if args.sam_RG else None),
                           refidx=args.refidx)
    else:
        suppress = (set(int(x) for x in args.suppress.split(","))
                    if args.suppress else set())
        writer = VerboseWriter(out, refnames, off_base=args.offbase,
                               full_ref=args.fullref, suppress=suppress,
                               cost=args.cost, show_seed=args.showseed,
                               partition=args.partition,
                               global_seed=args.seed)

    one_pair_file = bool(args.tabbed)    # --12: whole pair in one record
    un_f = _DumpStream(args.un, one_pair_file, fmt) if args.un else None
    al_f = _DumpStream(args.al, one_pair_file, fmt) if args.al else None
    max_f = (_DumpStream(args.maxfile, one_pair_file, fmt)
             if args.maxfile else None)
    if max_f is None:
        # maxed reads dump to --un when --max isn't given
        # (HitSink::dumpMaxed falls through to dumpUnal, hit.h:458-460)
        max_f = un_f

    stats = AlignStats()
    metrics = AlignerMetrics() if args.stats else None
    batch_size = args.reads_per_batch or args.batch_size
    t0 = time.time()

    def pipelined(batches, align):
        """Depth-1 pipeline: batch k+1 aligns (device) while batch k's
        results are formatted and written (host) — the batched analog
        of the reference's overlapped worker threads."""
        with ThreadPoolExecutor(1) as ex:
            pending = None
            for batch in batches:
                fut = ex.submit(align, batch)
                if pending is not None:
                    yield pending[0], pending[1].result()
                pending = (batch, fut)
            if pending is not None:
                yield pending[0], pending[1].result()

    def emit_pe(r1, r2, res):
        """One pair's records and counts (bowtie_tpu/cli/align.py:762)."""
        stats.processed += 1
        if res.maxed and res.sampled:
            # -M: one pair sampled from the best stratum
            # (VerboseHitSink::reportMaxed paired, hit.cpp:28-53;
            # sam.cpp:273-298)
            stats.maxed += 1
            stats.aligned += 1
            stats.reported_pairs += 1
            for h in res.hits:
                if args.sam:
                    writer.hit(h, xms=res.nbuffered + 1, mapq=0)
                else:
                    h.oms = res.nbuffered
                    writer.hit(h)
            if max_f:
                max_f.write_pe(r1, r2)
        elif res.maxed:
            # -m exceeded without -M: counted, no paired record
            # (HitSink::reportMaxed is counter-only, hit.h:494-500)
            stats.maxed += 1
            if max_f:
                max_f.write_pe(r1, r2)
            emit_se_hits(res.se_hits)
        elif not res.hits:
            if args.sam and not args.no_unal:
                writer.unaligned(r1, nhits=0, paired=True, second=False)
                writer.unaligned(r2, nhits=0, paired=True, second=True)
            if (args.best or args.pev2) and args.reportse:
                # V2 + --reportse: a pair with no paired alignment is
                # finished as two reads through the SE sinks, so each mate
                # counts in the summary on its own
                stats.processed += 1
                nal = sum(1 for sh in res.se_hits if sh)
                stats.aligned += nal
                stats.failed += 2 - nal
                emit_se_hits(res.se_hits)
                if not any(res.se_hits) and un_f:
                    un_f.write_pe(r1, r2)
            elif any(res.se_hits):
                stats.aligned += 1
                emit_se_hits(res.se_hits)
            else:
                stats.failed += 1
                if un_f:
                    un_f.write_pe(r1, r2)
        else:
            stats.aligned += 1
            stats.reported_pairs += len(res.hits) // 2
            xms = len(res.hits) // 2
            for h in res.hits:
                if args.sam:
                    writer.hit(h, xms=xms)
                else:
                    writer.hit(h)
            if al_f:
                al_f.write_pe(r1, r2)

    def emit_se_hits(se_hits):
        """The --reportse single-end alignments of a pair's mates."""
        for sehits in se_hits:
            stats.reported += len(sehits)
            for h in sehits:
                if args.sam:
                    writer.hit(h, xms=len(sehits))
                else:
                    writer.hit(h)

    def emit_se(read, res):
        stats.processed += 1
        if metrics is not None:
            metrics.next_read(read.codes_fw)
            metrics.record_result(res)
        if res.maxed and res.sampled:
            # -M: the sampled hit is reported, SAM with MAPQ 0 and
            # XM:i:<buffered+1>, verbose with oms = buffered
            # (bowtie_tpu/cli/align.py:842-851)
            stats.maxed += 1
            stats.aligned += 1
            stats.reported += 1
            h = res.hits[0]
            if args.sam:
                writer.hit(h, xms=res.nbuffered + 1, mapq=0)
            else:
                h.oms = res.nbuffered
                writer.hit(h)
            if max_f:
                max_f.write_se(read)
        elif res.maxed:
            # -m exceeded: counted, but NO record is emitted
            # (HitSink::reportMaxed is counter-only, hit.h:494-500)
            stats.maxed += 1
            if max_f:
                max_f.write_se(read)
        elif not res.hits:
            stats.failed += 1
            if args.sam and not args.no_unal:
                writer.unaligned(read, nhits=0)
            if un_f:
                un_f.write_se(read)
        else:
            stats.aligned += 1
            stats.reported += len(res.hits)
            xms = len(res.hits)
            for h in res.hits:
                if args.sam:
                    writer.hit(h, xms=xms)
                else:
                    writer.hit(h)
            if al_f:
                al_f.write_se(read)

    if paired:
        # --12 files may mix paired (5-column) and unpaired (3-column)
        # records; the unpaired ones go to a single-end aligner with the
        # same policy (bowtie_tpu/cli/align.py:877-908)
        se_state = [None]

        def align_mixed(batch):
            res = [None] * len(batch)
            pair_i = [i for i, (_a, b) in enumerate(batch) if b is not None]
            solo_i = [i for i, (_a, b) in enumerate(batch) if b is None]
            if pair_i:
                for i, r in zip(pair_i, aligner.align_batch(
                        [batch[i] for i in pair_i])):
                    res[i] = r
            if solo_i:
                if se_state[0] is None:
                    se_state[0] = _build_stateful_se_aligner(args, idx,
                                                             policy, dev)
                for i, r in zip(solo_i, se_state[0].align_batch(
                        [batch[i][0] for i in solo_i])):
                    res[i] = r
            return res

        for batch, results in pipelined(src.batches(batch_size),
                                        align_mixed):
            for (r1, r2), res in zip(batch, results):
                if r2 is None:
                    emit_se(r1, res)
                else:
                    emit_pe(r1, r2, res)
    else:
        for batch, results in pipelined(src.batches(batch_size),
                                        aligner.align_batch):
            for read, res in zip(batch, results):
                emit_se(read, res)
    if metrics is not None:
        metrics.print(fallbacks=None if fallbacks is None else fallbacks())
    return _finish(args, stats, t0, out, un_f, al_f, max_f, part)


def _finish(args, stats, t0, out, un_f, al_f, max_f, part=None) -> int:
    if args.time:
        dt = time.time() - t0
        print(f"Time searching: {dt:.2f}s "
              f"({stats.processed/max(dt,1e-9):.0f} reads/s)",
              file=sys.stderr)
    if part is None:
        print_summary(args, stats)
    else:
        part.stats = stats
    for f in {id(x): x for x in (un_f, al_f, max_f) if x}.values():
        f.close()
    if args.hits:
        out.close()
    return 0


def print_summary(args, stats: AlignStats) -> None:
    """The end-of-run summary on stderr (HitSink::finish) for the counts
    `stats` under the options `args`."""
    # Summary prints even under --quiet: the reference's HitSink
    # quiet_ flag (hit.h:279) is never wired to ARG_QUIET, so the
    # actual binary always emits the end-of-run stats; --quiet
    # only silences other informational messages.
    # HitSink::finish (hit.h:270-346): without -M, maxed reads count
    # toward "at least one alignment"; with -M the sampled read was
    # tallied as aligned already and the maxed line reads "sampled"
    sample = args.sample_mhits is not None
    aligned_disp = stats.aligned + (0 if sample else stats.maxed)
    tot = max(1, stats.processed)
    print(f"# reads processed: {stats.processed}", file=sys.stderr)
    print(f"# reads with at least one alignment: {aligned_disp} "
          f"({100.0*aligned_disp/tot:.2f}%)",
          file=sys.stderr)
    print(f"# reads that failed to align: {stats.failed} "
          f"({100.0*stats.failed/tot:.2f}%)",
          file=sys.stderr)
    if stats.maxed:
        word = "sampled due to -M" if sample else "suppressed due to -m"
        print(f"# reads with alignments {word}: {stats.maxed} "
              f"({100.0*stats.maxed/tot:.2f}%)",
              file=sys.stderr)
    # four-case summary wording (HitSink::finish, hit.h:321-337)
    if stats.reported == 0 and stats.reported_pairs == 0:
        print("No alignments", file=sys.stderr)
    elif stats.reported == 0:
        print(f"Reported {stats.reported_pairs} paired-end alignments",
              file=sys.stderr)
    elif stats.reported_pairs == 0:
        print(f"Reported {stats.reported} alignments", file=sys.stderr)
    else:
        print(f"Reported {stats.reported_pairs} paired-end alignments and "
              f"{stats.reported} singleton alignments", file=sys.stderr)
    if getattr(args, "hadoopout", False):
        # Hadoop streaming counters (hit.h:338-344)
        print(f"reporter:counter:Bowtie,Reads with reported alignments,"
              f"{stats.aligned}", file=sys.stderr)
        print(f"reporter:counter:Bowtie,Reads with no alignments,"
              f"{stats.failed}", file=sys.stderr)
        print(f"reporter:counter:Bowtie,Reads exceeding -m limit,"
              f"{stats.maxed}", file=sys.stderr)
        # numReportedPaired counts individual mates (hit.h:343)
        print(f"reporter:counter:Bowtie,Unpaired alignments reported,"
              f"{stats.reported}", file=sys.stderr)
        print(f"reporter:counter:Bowtie,Paired alignments reported,"
              f"{2 * stats.reported_pairs}", file=sys.stderr)


class _DumpStream:
    """Lazy same-format read dump (--al/--un/--max).

    Mirrors HitSink's dump machinery (hit.h:385-490): files are opened on
    the first dumped read (no file is created otherwise); paired reads
    split into <base>_1/<base>_2 with the suffix before the last '.'
    (openOf, hit.h:629-649), except when the pair came from one file
    (--12), where the whole raw record rides on mate 1.  What's written is
    the raw input record (readOrigBuf), not a re-synthesized one."""

    def __init__(self, base: str, one_pair_file: bool, fmt: str):
        self.base = base
        self.one = one_pair_file
        self.fmt = fmt
        self.f = self.f1 = self.f2 = None

    def _mate_name(self, mate: int) -> str:
        dot = self.base.rfind(".")
        if dot == -1:
            return f"{self.base}_{mate}"
        return f"{self.base[:dot]}_{mate}{self.base[dot:]}"

    def _rec(self, read) -> bytes:
        if read.orig is not None:
            return read.orig
        if self.fmt == "fasta":
            return b">" + read.name + b"\n" + read.seq + b"\n"
        return (b"@" + read.name + b"\n" + read.seq + b"\n+\n" +
                read.qual + b"\n")

    def write_se(self, read):
        if self.f is None:
            self.f = open(self.base, "wb")
        self.f.write(self._rec(read))

    def write_pe(self, r1, r2):
        if self.one:
            self.write_se(r1)      # the raw line holds both mates
            return
        if self.f1 is None:
            self.f1 = open(self._mate_name(1), "wb")
            self.f2 = open(self._mate_name(2), "wb")
        self.f1.write(self._rec(r1))
        self.f2.write(self._rec(r2))

    def close(self):
        for f in (self.f, self.f1, self.f2):
            if f:
                f.close()


if __name__ == "__main__":
    sys.exit(main())

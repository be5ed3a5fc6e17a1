#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bowtie_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. device  - the card (nvidia-smi name and power limit), torch and CUDA
             versions, and the seconds nvcc takes to build csrc/.
2. index   - a seeded 4,600,000 bp genome in one record (the size of
             bowtie's bundled E. coli example index) with 64 planted
             copies of a 2 kb segment, built with the port's builder at
             bowtie-build's defaults (-o 5 -t 10, fw + mirror), loaded
             onto the card with and without a dense SA.
3. build   - the build and inspect tools on the card: phase index's genome
             as FASTA through bowtie_tpu_torch.cli.build.main(["--jax-sa",
             ...]) with the launch counters zeroed just before and read
             just after (the suffix arrays by prefix doubling, one K16
             sa_round launch a round); all six .ebwt files must equal
             phase index's host SA-IS files byte for byte.  Then
             cli.inspect.main on that index: its FASTA must decode to the
             genome and -s must name the record with its length.  K16
             held to its plain version on the card on every round of the
             forward text (nr, order, maxg); then, on a seeded
             100,000,000 bp text (the size of the C. elegans genome), the
             whole device SA, held to host SA-IS after phase dfs (record
             build_sais: SA-IS runs in a thread meanwhile; both timed), and
             the first and last rounds timed: K16 median of 20, the plain
             round median of 5, torch.sort(keys, stable=True) on the same
             packed keys median of 20 (the library yardstick, which the
             port never calls), and one K16 round of each traced
             (k16_split_ms: device ms and launches by kernel).  Its
             inputs come from a generator of its own (seed + 1), so
             every later phase reads what it read before this phase
             existed.
4. kernels - 2^20 seeded 36 bp reads (2^21 strands): K2 exact search,
             the walk table (walk_table_kernel, the layout K3's and K4's
             walk steps read), K3 resolve (walk-left over K2's top rows,
             and dense SA) and K4 (fused one-row path), each held equal
             element for element to its plain PyTorch version on the card
             and timed with CUDA events (median of 20 runs after warm-up;
             plain versions one run each, the run they are held to, with
             its work count; K3 dense's plain version median of 5; K3
             dense and torch.index_select timed in turns, 20 runs each,
             medians and spreads).  K3 walk and K4 are also held to their
             plain versions on the index with its SA sample thinned to
             offRate 13, where most walks pass MAX_WALK and end with
             ok=False.
             K15 (align_step: K2 and K3 fused, the step parallel/mesh.py
             runs on every shard) and the K3 remainder (bwt_rows_offsets:
             K3 masked by a valid flag; K2's top rows, valid where the
             range is not empty) run once each with the counters zeroed,
             held exactly to their plain versions and K15 to K2 then K3,
             and timed (median of 20; the plain versions one run, the
             one they are held to); K2 then K3 on the same strands (K3
             over every strand's row, masked, as the reference composes
             them) is timed beside K15.
5. cli     - the main path: 50,000 such reads as FASTQ through
             bowtie_tpu_torch.cli.align.main on the card (-v 0 -k 1
             verbose, through K4; -v 0 -a -m 3 -S, through K2 and K3
             walk), each with the launch counters zeroed just before and
             read just after; K3 walk's launch in the -a run (every row of
             the batch's ranges) is kept and held to its plain version on
             the same rows.  Every reported hit must equal its reference
             substring, every planted exact read must align, and the
             records of the first 1,000 reads must equal, byte for byte,
             what the same CLI writes for those reads on the CPU (the
             plain versions).  Then the same -a -m 3 alignment through the
             library (ExactAligner) with a dense-SA index, counted on its
             own: the only run of K3 dense, which no CLI path reaches; it
             must report what the CLI run reported.
6. dfs     - the DFS machine (-v 1/2): 16,384 such reads with a second
             mismatch in every fourth.  K6 (derive_rows), K7 (dfs_machine,
             K5 inlined) and K8 (dfs_pack) each held to its plain version
             on the card, exactly, for -v 1 -k 1, -v 2 -a -m 3 and -v 2 -a
             (plain -a: reads of the 64-copy repeat overflow the 8 hit
             slots) on the dense pair, and for -v 1 -k 1 on 4,096 reads
             with the pair thinned to offRate 13 (walk-left), where K7 is
             held to the plain version on the lanes that finishes within
             1,800 iterations, and on the lanes past that budget that K7
             finishes, to the host oracle (OracleAligner): the
             step-budget rule of align/dfs_device.py.  Every hit must
             equal its reference substring except at its reported
             mismatches.  The -v 2 -a -m 3 tables are timed; K7's and
             K8's bytes are those the run reads and writes, counted by
             the plain versions (K7's timed plain run counts them); one
             K8 call's launches and host syncs are counted (torch's sync
             debug mode), and the boolean index's syncs.  K7 is timed on
             every case (median of 10) and on the first 8,192 lanes of
             -v 2 -a -m 3 (the CLI's batch); each case's per-lane
             transitions are summarised (max, p50, p99, mean, warp
             efficiency: utils/kdiag.py lane_stats), and on -v 2 -a -m 3
             the slowest lane and its warp's 32 lanes are timed alone.
7. cli_v   - 50,000 such reads through the CLI on the card, -v 1 -k 1
             (verbose) and -v 2 -a -m 3 -S, each counted from zero and
             traced by torch.profiler for the device's busy share, with
             the lanes re-run on the host oracle counted; the records of
             the first 400 reads must equal the CPU CLI's byte for byte,
             and the library aligner's results on them the host oracle's.
8. n       - bowtie's default seeded mode: 16,384 reads of the cli_v mix
             with three mismatches in every third read and qualities from
             Phred 2-40.  Under -n 2 -k 1, -n 3 -l 20 -a -m 3 and -n 1
             --nomaqround -e 40, launch A runs on the card (K6, K7), then
             K9 (derive_b_jobs) and launch B's K7 are each held exactly to
             their plain versions on the same inputs; K8 packs both
             launches and every hit must equal its reference substring
             except at its reported mismatches.  K9 is timed under -n 2
             -k 1; its bytes are the lanes' scalars, their counted partial
             rows and the [B, 36, NJF] table it writes (k9_bytes).  Launch
             B's K7 is timed under each policy (median of 10), its
             per-lane transitions summarised.  Then at the CLI's shape
             (jobs_cli_shape): -n 2 -k 1 launch A on the first 8,192
             reads, K9 on its 8,192 lanes and K6 on the launch-B table it
             builds (8,192 x 36 rows, L 40), each held exactly to its
             plain version and timed: the kernels line's K6 and K9 rows.
9. cli_n   - 50,000 such reads through the CLI on the card, bowtie's
             default command (no mode flag: -n 2 -l 28 -e 70 -k 1,
             verbose) and -n 2 -a -m 3 -S, each counted from zero and
             traced, held to the CPU CLI and the host oracle on the first
             400 reads as in cli_v; then --sanity --stats on those reads
             (every batch also through the host oracle) and -n 2 on the
             in-repo .ebwtl index (tests/golden/small_index_l) against the
             CPU CLI, both off the main path.
10. best    - the best-first machine: 2,048 reads of the n phase's mix.
             K10 (best_machine) and K11 (best_pack) each held exactly to
             its plain version on the card under -v 2 -k 3 --best --strata,
             -v 3 -m 1 --best and -n 2 -M 1 --best on the dense pair (plain
             budget 2,000 iterations), and -v 1 -k 1 --best on 128 reads
             with the pair thinned to offRate 13 (walk-left; budget 2,500):
             K10 lane for lane wherever the plain version finished within
             its budget, and on the first 96 lanes past that budget that
             K10 finished, through the aligner's assemble, to the host
             best-first engine (the budget rule of align/best_device.py).  Every hit must equal its reference
             substring except at its reported mismatches.  The first policy
             is timed: K10's launch alone (events around the C entry,
             median of 10) and the wrapper's call with its packing and
             uploads (median of 5); K10's bytes are those the run reads
             and writes, counted by the plain version in its one, timed,
             run.
11. cli_best - 25,000 such reads through the CLI on the card, -v 2 -m 1
             --best --strata -S and -n 2 --best -k 1 (verbose), each counted
             from zero and traced, with the reads re-run on the host engine
             counted; every hit must equal its reference substring except at
             its reported mismatches, and the records of the first 160
             reads must equal the CPU CLI's byte for byte.  K10 alone is
             timed on the first run's first batch (8,192 reads, the
             CLI's own call; no plain run): the K10 line's cli_batch.
12. pe     - the paired recorder: 512 pairs of 50 bp mates (pe_pairs: the
             n phase's error and quality mix, fragments of 100-250 bases,
             10 % with a random mate, 5 % 400-600 apart), all four anchor
             streams of each in one fused launch (2,048 lanes).  K12
             (exact_ranges_cat) held exactly to its plain version on the
             card on the 2,048 lanes of phase 0's matrix (each mate in each
             orientation, on the forward or the mirror index) and timed
             there (median of 20; plain the one run it is held to), and
             again at 2^21 strands of the kernels phase's read mix (their
             own generator, seed + 2), forward and mirror lanes
             alternating, beside K2.
             K10r (best_machine in record mode) held exactly to its plain
             version on the card (hits, nhits, overflow, mode) on every
             lane the plain version finished within its budget, under -n 2
             -k 1 at rec_cap 1 (the lanes phase 0 leaves) and -v 2 -a -m 3
             (uncapped, every lane) on the dense pair, and -n 2 -k 1 at
             rec_cap 1 on 128 pairs with the pair thinned to offRate 13
             (walk-left).  The first policy is timed (as K10 is);
             K10r's bytes are
             those the run reads and writes (k10_bytes), counted by its
             one, timed, plain run.  K13 (pe_ilv,
             the V1 interleave, chase and rescue) held exactly to its
             plain version on the card, all 12 outputs and each pair's
             iterations, on round 1's streams (rec_cap 1 after phase 0)
             of the 512 pairs (timed: median of 20, plain the one run it
             is held to; its bound from what the plain version counts, k13_bounds),
             of the 128 pairs on the offRate-13 pair (walk-left; many
             pairs run out of the 4,096-iteration budget) and of 256
             pairs of the in-repo small_index (five fragments: the
             fragment search of joinedToTextOff; small_pairs, from the
             K12 generator).
13. pev2   - K14, the best-first machine in paired record mode (the V2
             recorder's merged-mate DAG, csrc/best.cu's paired
             instantiation), held exactly to its plain version on the card
             (hits, nhits, mode, result, count; overflow flags) on every
             lane the plain version finished within its budget, and K11
             on its records: -n 3 --best (16 / 48 drivers, uncapped) and
             -n 2 --best (12 / 28, rec_cap 8) on the offRate-13 pair, on
             256 pe_pairs (their own generator, seed + 3).  This is the
             budget case: the plain version stops at 300 iterations, and
             every pair past it that K14 finished replays its stream to
             the result of the V2 host engine.  K14 on whole lanes, timed,
             is cli_pe's case on the CLI's first --best batch.
14. cli_pe - 12,000 such pairs through the CLI on the card, bowtie's
             default paired command (-1/-2, verbose: -n 2 -l 28 -e 70 -k 1
             --fr -X 250; phase 0 on K12, K10r at rec_cap 1, then K13) and -v 2
             -a -m 1 -S, each counted from zero and traced (the default
             command after a warm-up run), with the lanes phase 0 settled
             (synthesized), the
             lanes K10r ran and those that overflowed, by mate length, per
             round (rec_cap 1, then None for round 2), the pairs K13
             decided, escalated and left to the host replay per round
             and its launches, the pairs re-run on the host drivers
             (fallbacks) and re-recorded uncapped (escalations) counted; every reported mate must equal its
             reference substring except at its reported mismatches.  The
             default command on the first 400 pairs must write what the
             port's V1 host engine writes (build_aligner(host_engine=
             True)), and with -p 4 on the first 800 what it writes with
             -p 1.  K13 held exactly to its plain version on round 1's
             streams of the CLI's first batch (8,192 pairs, the default
             command's aligner), timed as in pe: the numbers of K13's
             line in the kernels line, the 512 pairs of pe beside them.
             Then --best (-n 2 -k 1 --best --fr -X 250: the V2 engine,
             K14 and K11) on the 12,000 pairs, counted from zero and
             traced, with its host re-runs (fallbacks) and
             re-recordings (escalations) counted and every reported mate
             checked against the genome; on the first 400 pairs it must
             write what the V2 host engine writes (build_aligner(
             host_engine=True)), both timed; on the 800 pairs of the -p
             slice, -p 4 must write what -p 1 writes, and what the V2
             host engine writes at -p 4, all three timed.  K14 is held to
             its plain version on the --best run's first batch (8,192
             pairs, the CLI's aligner, rec_cap 8: some lanes must reach
             it), timed (K14's launch alone median of 10, the wrapper's
             call median of 5, the plain version one run that also counts
             the work its bound prices): the numbers of K14's line in the
             kernels line.
15. mesh   - K15 over a mesh of four entries, all the one card (one index
             copy; each shard one launch on its stream), with the K3
             remainder on each shard's top rows, and run_sharded (K6, K7)
             over two such entries on phase dfs's 16,384 -v 2 -a -m 3
             lanes, all counted from zero; the shards' arrays must equal
             one align_step's, and run_sharded's one run_machine's, key by
             key, with the most transitions.
16. cli_dist - the launcher (python -m bowtie_tpu_torch.parallel.launch),
             two gloo ranks as subprocesses on the one card, on cli_n's
             50,000-read file: bowtie's default command (held to cli_n's
             own run), -v 0 -a -m 3 -S and -v 0 -S -s 1000 -u 30000 --un:
             the merged hits and --un file and rank 0's stderr must equal
             one process's byte for byte, each timed (two ranks on one
             card: not a scaling figure).

Phase device also prints the local memory per thread of K10's two
instantiations (K10 and K10r; K14), of K13 and of K6 and K9 (which must
be 0), and ptxas's lines about them and about K7's two layouts (stack
frame, spills, registers); K13's entry in the kernels line repeats its
own, with its launch shape on the CLI's batch, and so do K6's and K9's,
timed at the CLI's shape.  Then the
{"kernels": [...]} line (launches: the CLI runs, cli build included; K3
dense's library-run launches beside its 0; K15's and the K3 remainder's,
which no CLI path runs, phases kernels' and mesh's), the seconds of
each phase and of the script, the nvidia-smi line, and last {"ok": true,
"device": {...}}.  Any failure raises and the script exits non-zero
without that last line.  It needs one CUDA device and writes only under
.smoke/ in the checkout.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from bowtie_tpu_torch import kernels  # noqa: E402
from bowtie_tpu_torch.align import best_device as bd  # noqa: E402
from bowtie_tpu_torch.align import dfs_device as dfs  # noqa: E402
from bowtie_tpu_torch.align import n_device as nd  # noqa: E402
from bowtie_tpu_torch.align.backtrack_oracle import QUAL_ROUNDS  # noqa: E402
from bowtie_tpu_torch.align.dfs_jobs import (  # noqa: E402
    build_n_jobs_a_vec, build_v_jobs_vec)
from bowtie_tpu_torch.align.drivers import OracleAligner  # noqa: E402
from bowtie_tpu_torch.align.golden import GoldenFM  # noqa: E402
from bowtie_tpu_torch.align import pe_device as pe  # noqa: E402
from bowtie_tpu_torch.align import pe_ilv_device as ilv  # noqa: E402
from bowtie_tpu_torch.align import pipeline as tpipe  # noqa: E402
from bowtie_tpu_torch.align.pe_device import (  # noqa: E402
    DevicePairedBestAligner, exact_ranges_cat, exact_ranges_cat_plain)
from bowtie_tpu_torch.align.pev2_device import (  # noqa: E402
    DevicePairedV2Aligner)
from bowtie_tpu_torch.align.exact import (  # noqa: E402
    bwt_rows_offsets, bwt_rows_offsets_plain, exact_ranges,
    exact_ranges_plain, resolve_rows, resolve_rows_plain, walk_table,
    walk_table_plain)
from bowtie_tpu_torch.align.pipeline import (  # noqa: E402
    ExactAligner, one_row, one_row_plain)
from bowtie_tpu_torch.align.policy import INF, KPolicy  # noqa: E402
from bowtie_tpu_torch.build import sa as bsa  # noqa: E402
from bowtie_tpu_torch.build.builder import build_index  # noqa: E402
from bowtie_tpu_torch.cli import align as cli  # noqa: E402
from bowtie_tpu_torch.cli import build as build_cli  # noqa: E402
from bowtie_tpu_torch.cli import inspect as inspect_cli  # noqa: E402
from bowtie_tpu_torch.index.arrays import from_ebwt  # noqa: E402
from bowtie_tpu_torch.index.ebwt_io import (  # noqa: E402
    read_bitpair_reference, read_ebwt, unpack_reference)
from bowtie_tpu_torch.io.readers import (  # noqa: E402
    PairedReadSource, ReadSource)
from bowtie_tpu_torch.parallel import dfs_mesh  # noqa: E402
from bowtie_tpu_torch.parallel.mesh import (  # noqa: E402
    align_step, align_step_plain, make_mesh, replicate_index,
    shard_reads, sharded_align_step)
from bowtie_tpu_torch.utils.kdiag import lane_stats, ptxas_entry  # noqa: E402
from bowtie_tpu_torch.utils.rng import fill_seed_caches  # noqa: E402
from bowtie_tpu_torch.utils.yardstick import (  # noqa: E402
    COMP, HBM_BYTES_PER_S, INT32_OPS_PER_S, KINDS, L2_BYTES, READ_LEN,
    SECTOR, SECTORS_PER_WALK_STEP, bounds, make_reads, strand_matrix)

SOURCE = "bowtie_tpu_torch/csrc/exact.cu"
DFS_SOURCE = "bowtie_tpu_torch/csrc/dfs.cu"
JOBS_SOURCE = "bowtie_tpu_torch/csrc/jobs.cu"
NO_LIBRARY = "n/a: no single PyTorch call computes an FM backward search"
NO_LIBRARY_K6 = ("n/a: no single PyTorch call derives the by-depth rows "
                 "and N gates")
NO_LIBRARY_K7 = "n/a: no single PyTorch call runs a backtracking search"
NO_LIBRARY_K9 = ("n/a: no single PyTorch call derives the launch-B job "
                 "table")
NO_LIBRARY_K10 = ("n/a: no single PyTorch call runs a best-first "
                  "branch-and-bound search")
BEST_SOURCE = "bowtie_tpu_torch/csrc/best.cu"
SA_SOURCE = "bowtie_tpu_torch/csrc/sa.cu"
CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------- inputs

def make_genome(rng, length: int, copies: int, seg_len: int):
    """Random ACGT genome with `copies` copies of one segment, one copy
    at a random offset in each of `copies` equal slices."""
    g = rng.integers(0, 4, length).astype(np.uint8)
    seg = rng.integers(0, 4, seg_len).astype(np.uint8)
    slice_len = length // copies
    starts = (np.arange(copies) * slice_len
              + rng.integers(0, slice_len - seg_len, copies))
    for s in starts:
        g[s:s + seg_len] = seg
    return g, starts


# ---------------------------------------------------------------- timing

def time_ms(fn, device, iters: int, warmup: int = 2) -> float:
    """Median time of fn() in ms: CUDA events on the card, the host
    clock elsewhere.  On the card a ~0.5 ms spin kernel runs first, so
    the host has queued fn's launches before the start event fires and
    the events time the device work, not the Python launch path."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def time_alternate(fns, device, runs: int, warmup: int = 2) -> list:
    """Each of fns timed `runs` times in turns (fns[0], fns[1], ...,
    fns[0], ...), as time_ms times one run; -> one list of ms per fn."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for _ in range(runs):
        for fn, ts in zip(fns, times):
            ts.append(time_ms(fn, device, 1, warmup=0))
    return times


def spread(ts) -> dict:
    return dict(median=statistics.median(ts), min=min(ts), max=max(ts))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def sync_all() -> None:
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def time_all_ms(fn, iters: int) -> float:
    """Mean ms of fn() on the host clock, every card synchronised before
    and after the `iters` calls (work spread over several cards)."""
    fn()
    sync_all()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    sync_all()
    return 1e3 * (time.perf_counter() - t) / iters


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


# ---------------------------------------------------------------- phases

def phase_index(rng, work, device, genome_len, copies, seg_len):
    genome, rep_starts = make_genome(rng, genome_len, copies, seg_len)
    base = os.path.join(work, "genome")
    t = time.time()
    build_index([genome], ["synthetic_4.6M seeded"], base,
                off_rate=5, ftab_chars=10)
    build_s = time.time() - t
    t = time.time()
    idx = read_ebwt(base)
    fm = from_ebwt(idx, device=device)
    fm_sa = from_ebwt(idx, device=device, dense_sa=True)
    sync(device)
    load_s = time.time() - t
    require(idx.length == genome_len and idx.off_rate == 5
            and idx.ftab_chars == 10, "index header")
    emit({"phase": "index", "genome_bp": genome_len,
          "planted_copies": copies, "segment_bp": seg_len,
          "build_s": build_s, "load_s": load_s,
          "device_bytes": fm.nbytes(),
          "device_bytes_dense_sa": fm_sa.nbytes()})
    return genome, rep_starts, base, idx, fm, fm_sa


# K16 at bowtie-build's common input size: the C. elegans genome, ~100 Mbp
SA_BIG_BP = 100_000_000


def k16_bounds(n1: int) -> dict:
    """The least time one prefix-doubling round over n1 ranks could take:
    the larger of its bytes (r read once, nr and order written once, 4
    bytes each, and maxg) over the HBM rate, and its integer operations
    (per element: the key's multiply and add, ceil(log2 n1) comparisons
    that ordering n1 keys needs at least, one comparison to renumber)
    over the int32 rate."""
    nbytes = 12 * n1 + 4
    int_ops = n1 * (3 + max(1, (n1 - 1).bit_length()))
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * int_ops / INT32_OPS_PER_S
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms, int_ops=int_ops,
                bytes=nbytes)


def kernel_split(fn) -> dict:
    """Device time and launches of one fn() by kernel: torch.profiler's
    kernels and memsets, each under its own name (template arguments,
    parameters and namespace cut), {name: {"ms", "launches"}}, and
    "total_ms"."""
    sync_all()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        sync_all()
    split = {}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        key = e.key.replace("(anonymous namespace)::", "")
        m = re.search(r"(\w+)\s*[<(]", key)
        part = split.setdefault(m.group(1) if m else key,
                                {"ms": 0.0, "launches": 0})
        part["ms"] += e.self_device_time_total / 1e3
        part["launches"] += e.count
    if not split:
        return {"note": "not measured: torch.profiler showed no device "
                        "time"}
    split["total_ms"] = sum(v["ms"] for v in split.values())
    return split


def host_syncs(fn) -> int:
    """The synchronising CUDA calls one fn() makes, as torch's sync debug
    mode reports them."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def k16_rounds(codes, device, check_plain: bool):
    """Run the doubling loop on the card through K16 -> (SA, the ranks and
    step of the first and of the last round, BIG, rounds); with
    check_plain, every round's nr, order and maxg must equal the plain
    round's on the same inputs."""
    n = len(codes)
    r0, big = bsa.initial_ranks(codes)
    r = torch.from_numpy(r0).to(device)
    first = (r, 1)
    k, rounds = 1, 0
    while True:
        kk = min(k, n + 1)
        nr, order, maxg = bsa.sa_round(r, kk, big)
        if check_plain:
            pnr, porder, pmaxg = bsa.sa_round_plain(r, kk, big)
            err = max_abs_err([(nr, pnr), (order, porder), (maxg, pmaxg)])
            require(err == 0, f"K16 round {rounds} (k={kk}) disagrees "
                    f"with its plain version by {err}")
        rounds += 1
        if int(maxg) == n:
            return order, first, (r, kk), big, rounds
        r, k = nr, 2 * k


def phase_build(rng, work, device, genome, base, gpu):
    """bowtie-build --jax-sa and bowtie-inspect through the port's CLIs on
    phase index's genome, K16 against its plain version on every round of
    its forward text, and K16 timed at 100 Mbp.  Host SA-IS of the 100 Mbp
    text runs in a thread (its ctypes call lets go of the GIL) while this
    and the next phases use the card.  -> (the K16 entry, the launches,
    the check that joins that thread and holds the device SA to it)."""
    text = rng.integers(0, 4, SA_BIG_BP, dtype=np.uint8)
    sais = {}

    def run_sais():
        t = time.time()
        sais["sa"] = bsa.suffix_array(text)
        sais["s"] = time.time() - t
    sais_thread = threading.Thread(target=run_sais, daemon=True)
    sais_thread.start()
    name = "synthetic_4.6M seeded"
    fasta = os.path.join(work, "genome.fa")
    chars = CHARS[genome].tobytes()
    with open(fasta, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        for i in range(0, len(chars), 60):
            f.write(chars[i:i + 60] + b"\n")
    base_dev = os.path.join(work, "genome_dev")

    def build():
        t = time.time()
        rc = build_cli.main(["--jax-sa", "-q", fasta, base_dev],
                            device=device)
        sync(device)
        return rc, time.time() - t

    (rc, build_s), launches = counted(build, device)
    require(rc == 0, f"cli build --jax-sa exited {rc}")
    require(launches["sa_round"] > 0, f"cli build launched {launches}")
    exts = (".1.ebwt", ".2.ebwt", ".3.ebwt", ".4.ebwt", ".rev.1.ebwt",
            ".rev.2.ebwt")
    for ext in exts:
        with open(base + ext, "rb") as a, open(base_dev + ext, "rb") as b:
            require(a.read() == b.read(), f"--jax-sa {ext} differs from "
                    "the host SA-IS build's")

    def inspect(args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            require(inspect_cli.main(args + [base_dev]) == 0,
                    f"cli inspect {args} failed")
        return out.getvalue()

    t = time.time()
    lines = inspect([]).split("\n")
    inspect_s = time.time() - t
    require(lines[0] == ">" + name, f"inspect names {lines[0]!r}")
    require("".join(lines[1:]).encode() == chars,
            "inspect does not decode to the genome")
    summary = inspect(["-s"]).splitlines()
    require(summary[-1] == f"Sequence-1\t{name}\t{len(genome)}",
            f"inspect -s ends {summary[-1]!r}")

    # K16 against its plain version on every round of the forward text
    _, _, _, _, fw_rounds = k16_rounds(genome, device, check_plain=True)

    # K16 timed at 100 Mbp, first and last round
    t = time.time()
    sa_dev = bsa.suffix_array_doubling(text, device)
    dev_s = time.time() - t
    order, first, last, big, big_rounds = k16_rounds(text, device,
                                                     check_plain=False)
    del order
    n1 = SA_BIG_BP + 1
    timed = {}
    for tag, (r, k) in (("first", first), ("last", last)):
        got = bsa.sa_round(r, k, big)
        want = bsa.sa_round_plain(r, k, big)
        err = max_abs_err(list(zip(got, want)))
        require(err == 0, f"K16 {tag} round at 100 Mbp disagrees by {err}")
        del got, want
        r2 = torch.full_like(r, big)
        r2[:n1 - k] = r[k:]
        keys = r.long() * (big + 1) + r2.long()
        del r2
        timed[tag] = dict(
            k=k, max_abs_err=err,
            ms=time_ms(lambda: bsa.sa_round(r, k, big), device, 20),
            plain_ms=time_ms(lambda: bsa.sa_round_plain(r, k, big),
                             device, 5),
            library_ms=time_ms(lambda: torch.sort(keys, stable=True),
                               device, 20),
            split=kernel_split(lambda: bsa.sa_round(r, k, big)))
        del keys
    del first, last
    torch.cuda.empty_cache()

    fl = timed["first"]
    # digit passes of this text's keys, and the kernels a round launched
    passes = -(-((big + 1) ** 2 - 1).bit_length() // 8)
    per_round = {t: None if "note" in v["split"] else sum(
        p["launches"] for name, p in v["split"].items()
        if name not in ("Memset", "total_ms")) for t, v in timed.items()}
    entry = dict(
        name="K16 sa_round", route="cuda", source=SA_SOURCE,
        replaces="bowtie_tpu/build/sa.py:137",
        ms=fl["ms"], plain_ms=fl["plain_ms"], **k16_bounds(n1),
        library_ms=fl["library_ms"],
        library="torch.sort(packed keys, stable=True)",
        max_abs_err=0, match=True, suffixes=n1,
        last_round=timed["last"], rounds_100m=big_rounds,
        rounds_fw_4_6m=fw_rounds, passes=passes,
        kernels_per_round=per_round)
    emit({"phase": "build", "gpu": gpu, "genome_bp": len(genome),
          "cli_build_s": build_s, "launches": launches,
          "files_equal_host_sais": True, "inspect_s": inspect_s,
          "inspect_decodes": True, "k16_rounds_checked": fw_rounds,
          "sa_100m": {"bp": SA_BIG_BP, "rounds": big_rounds,
                      "device_s": dev_s},
          "k16_ms": {t: v["ms"] for t, v in timed.items()},
          "plain_ms": {t: v["plain_ms"] for t, v in timed.items()},
          "library_ms": {t: v["library_ms"] for t, v in timed.items()},
          "k16_split_ms": {t: v["split"] for t, v in timed.items()},
          "k16_passes": passes, "k16_kernels_per_round": per_round})

    def check_sais():
        sais_thread.join()
        require("sa" in sais, "host SA-IS of the 100 Mbp text failed")
        require(np.array_equal(sa_dev, sais["sa"]),
                "the 100 Mbp device SA differs from SA-IS")
        emit({"phase": "build_sais", "bp": SA_BIG_BP, "sais_s": sais["s"],
              "equal": True})
    return {"K16": entry}, {"cli build --jax-sa": launches}, check_sais


def phase_kernels(rng, device, genome, rep_starts, seg_len, fm, fm_sa,
                  n_reads):
    codes, lens, _kind, _pos, _strand = make_reads(
        rng, genome, rep_starts, seg_len, n_reads)
    mat_np, lens_np = strand_matrix(codes, lens)
    mat = torch.from_numpy(mat_np).to(device)
    lens2 = torch.from_numpy(lens_np).to(device)
    n, L = mat.shape
    seeds = torch.from_numpy(
        rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
    ).to(device)
    out = {}
    index_rank = _nbytes(fm.bwt, fm.occ)     # what every LF step reads

    # K2
    top, bot = exact_ranges(fm, mat, lens2)
    k2_work = torch.zeros(2, n, dtype=torch.int64, device=device)
    (ptop, pbot), k2_plain_ms = time_once(
        lambda: exact_ranges_plain(fm, mat, lens2, k2_work), device)
    err = max_abs_err([(top, ptop), (bot, pbot)])
    require(err == 0, f"K2 disagrees with its plain version by {err}")
    hit = bot > top
    n_ftab = int((lens2 >= fm.ftab_chars).sum())
    lf_steps, k2_words = (int(x) for x in k2_work.sum(1))
    out["K2"] = dict(
        name="K2 exact_ranges", route="cuda", source=SOURCE,
        replaces="bowtie_tpu/align/exact.py:37",
        ms=time_ms(lambda: exact_ranges(fm, mat, lens2), device, 20),
        plain_ms=k2_plain_ms,
        **bounds(index_rank + _nbytes(fm.ftab_hi, fm.ftab_lo, mat, lens2)
                 + 16 * n, 2 * lf_steps, 0, k2_words,
                 2 * n_ftab + 2 * 2 * lf_steps),
        library_ms=None, library=NO_LIBRARY, max_abs_err=err, match=True,
        strands=n, strands_hit=int(hit.sum()), lf_steps_per_end=lf_steps)

    # the walk table that K3's and K4's walk steps read, built anew
    table = walk_table(fm)
    walk_bytes = _nbytes(table)              # what every walk step reads
    ptable, table_plain_ms = time_once(lambda: walk_table_plain(fm), device)
    err = max_abs_err([(table, ptable)])
    require(err == 0, f"the walk table disagrees with its plain version "
            f"by {err}")
    nb = fm.occ.shape[0] - 1
    table_bytes = 32 * nb + 16 * nb + _nbytes(table)   # words, occ, table
    out["K3t"] = dict(
        name="K3 walk table (walk_table_kernel)", route="cuda",
        source=SOURCE,
        replaces="bowtie_tpu/align/exact.py:99 (the layout its walk reads)",
        ms=time_ms(lambda: walk_table(dataclasses.replace(
            fm, walk=None, kernel_view=None)), device, 20),
        plain_ms=table_plain_ms,
        **bounds(table_bytes, 0, 0, 0, table_bytes // SECTOR),
        library_ms=None,
        library="n/a: no single PyTorch call builds the walk table",
        max_abs_err=err, match=True, entries=int(table.shape[0]),
        table_bytes=_nbytes(table))

    # K3 over K2's top rows, walk-left and dense SA
    rows = top[hit].contiguous()
    m = rows.numel()
    off, ok = resolve_rows(fm, rows)
    walk = torch.zeros(2, m, dtype=torch.int64, device=device)
    (poff, pok), k3_plain_ms = time_once(
        lambda: resolve_rows_plain(fm, rows, walk), device)
    err = max_abs_err([(off, poff), (ok, pok)])
    require(err == 0, f"K3 (walk) disagrees with its plain version by {err}")
    require(bool(ok.all()), "K3 walk overflow on the smoke input")
    walk_steps, walk_words = (int(x) for x in walk.sum(1))
    out["K3w"] = dict(
        name="K3 resolve_rows (walk)", route="cuda", source=SOURCE,
        replaces="bowtie_tpu/align/exact.py:99",
        ms=time_ms(lambda: resolve_rows(fm, rows), device, 20),
        plain_ms=k3_plain_ms,
        **bounds(walk_bytes + _nbytes(fm.offs, rows) + 9 * m, walk_steps,
                 walk_steps, walk_words,
                 SECTORS_PER_WALK_STEP * walk_steps + m),
        library_ms=None, library=NO_LIBRARY, max_abs_err=err, match=True,
        rows=m, walk_steps=walk_steps,
        max_walk=int(walk[0].max()) if m else 0)

    soff, sok = resolve_rows(fm_sa, rows)
    psoff, psok = resolve_rows_plain(fm_sa, rows)
    err = max_abs_err([(soff, psoff), (sok, psok), (soff, off)])
    require(err == 0, f"K3 (dense SA) disagrees by {err}")
    sa_sectors = int(torch.unique(rows >> 3).numel())   # 8 entries/sector
    # the kernel and the library call timed in turns, 20 runs each
    k3s_t, lib_t = time_alternate(
        [lambda: resolve_rows(fm_sa, rows),
         lambda: torch.index_select(fm_sa.sa, 0, rows)], device, 20)
    out["K3s"] = dict(
        name="K3 resolve_rows (dense SA)", route="cuda", source=SOURCE,
        replaces="bowtie_tpu/align/exact.py:99",
        ms=statistics.median(k3s_t),
        plain_ms=time_ms(lambda: resolve_rows_plain(fm_sa, rows), device, 5),
        **bounds(SECTOR * sa_sectors + 8 * m + 9 * m, 0, 0, 0, m),
        library_ms=statistics.median(lib_t),
        library="torch.index_select(sa, 0, rows)",
        alternating_runs=20, ms_spread=spread(k3s_t),
        library_ms_spread=spread(lib_t),
        max_abs_err=err, match=True, rows=m)

    # K4
    res = one_row(fm, mat, lens2, seeds)
    k4_work = torch.zeros(2, n, dtype=torch.int64, device=device)
    pres, k4_plain_ms = time_once(
        lambda: one_row_plain(fm, mat, lens2, seeds, k4_work), device)
    err = max_abs_err([(res, pres)])
    require(err == 0, f"K4 disagrees with its plain version by {err}")
    k4_steps, k4_words = (int(x) for x in k4_work.sum(1))
    k4_walk = k4_steps - lf_steps
    out["K4"] = dict(
        name="K4 one_row", route="cuda", source=SOURCE,
        replaces="bowtie_tpu/align/pipeline.py:53",
        ms=time_ms(lambda: one_row(fm, mat, lens2, seeds), device, 20),
        plain_ms=k4_plain_ms,
        **bounds(index_rank + walk_bytes
                 + _nbytes(fm.ftab_hi, fm.ftab_lo, fm.offs, mat, lens2,
                           seeds) + 24 * n,
                 2 * lf_steps + k4_walk, k4_walk, k4_words,
                 2 * n_ftab + 2 * 2 * lf_steps
                 + SECTORS_PER_WALK_STEP * k4_walk + n),
        library_ms=None, library=NO_LIBRARY, max_abs_err=err, match=True,
        strands=n, walk_steps=k4_walk)

    # K3 walk and K4 past MAX_WALK: the same index with only every 256th
    # SA sample (offRate 13), where most walks end with ok=False
    thin = dataclasses.replace(fm, offs=fm.offs[::256].contiguous(),
                               off_rate=fm.off_rate + 8, kernel_view=None)
    sub = slice(0, 1 << 16)
    trows = rows[sub]
    toff, tok = resolve_rows(thin, trows)
    ptoff, ptok = resolve_rows_plain(thin, trows)
    tres = one_row(thin, mat[sub], lens2[sub], seeds[sub])
    ptres = one_row_plain(thin, mat[sub], lens2[sub], seeds[sub])
    err = max_abs_err([(toff, ptoff), (tok, ptok), (tres, ptres)])
    require(err == 0, f"K3/K4 past MAX_WALK disagree by {err}")
    k3_over = int((~tok).sum())
    k4_hit = tres[0] > 0
    k4_over = int((tres[2][k4_hit] == 0).sum())
    require(0 < k3_over < trows.numel() and 0 < k4_over < int(k4_hit.sum()),
            f"thinned index: {k3_over} K3 and {k4_over} K4 walks past "
            "MAX_WALK, want some but not all")
    out["K3w"].update(overflow_rows=trows.numel(), overflow_not_ok=k3_over)
    out["K4"].update(overflow_strands=int(k4_hit.sum()),
                     overflow_not_ok=k4_over)

    # K15 (K2 and K3 fused, the step parallel/mesh.py runs on every shard)
    # and the K3 remainder (K3 masked by a valid flag), each run once
    # with the counters zeroed: the launches of this phase
    (got, (rem, rem_ok)), launches = counted(
        lambda: (align_step(fm, mat, lens2),
                 bwt_rows_offsets(fm, top, hit)), device)
    want, k15_plain_ms = time_once(
        lambda: align_step_plain(fm, mat, lens2), device)
    err = max_abs_err(list(zip(got, want)))
    require(err == 0, f"K15 disagrees with its plain version by {err}")
    k2k3_off, k2k3_ok = resolve_rows(fm, torch.where(hit, top, 0))
    err_k2k3 = max_abs_err([
        (got[0], top), (got[1], bot),
        (got[2], torch.where(hit, k2k3_off, 0xFFFFFFFF)),
        (got[3], k2k3_ok & hit)])
    require(err_k2k3 == 0, f"K15 disagrees with K2 then K3 by {err_k2k3}")

    def k2_then_k3():
        t, b = exact_ranges(fm, mat, lens2)
        return resolve_rows(fm, torch.where(b > t, t, 0))

    k15_nbytes = (index_rank + walk_bytes
                  + _nbytes(fm.ftab_hi, fm.ftab_lo, fm.offs, mat, lens2)
                  + 25 * n)
    out["K15"] = dict(
        name="K15 align_step (K2 + K3 fused; parallel/mesh.py)",
        route="cuda", source=SOURCE,
        replaces="bowtie_tpu/parallel/mesh.py:55",
        ms=time_ms(lambda: align_step(fm, mat, lens2), device, 20),
        plain_ms=k15_plain_ms,
        k2_k3_ms=time_ms(k2_then_k3, device, 20),
        k2_plus_k3w_ms=out["K2"]["ms"] + out["K3w"]["ms"],
        **bounds(k15_nbytes, 2 * lf_steps + walk_steps, walk_steps,
                 k2_words + walk_words,
                 2 * n_ftab + 2 * 2 * lf_steps
                 + SECTORS_PER_WALK_STEP * walk_steps + m),
        library_ms=None, library=NO_LIBRARY, max_abs_err=err,
        max_abs_err_vs_k2_k3=err_k2k3, match=True, strands=n,
        strands_hit=int(hit.sum()))
    (prem, prem_ok), k3r_plain_ms = time_once(
        lambda: bwt_rows_offsets_plain(fm, top, hit), device)
    err = max_abs_err([(rem, prem), (rem_ok, prem_ok),
                       (rem[hit], got[2][hit])])
    require(err == 0, f"K3 remainder disagrees with its plain version or "
            f"K15 by {err}")
    out["K3r"] = dict(
        name="K3 remainder bwt_rows_offsets (K3 masked by valid)",
        route="cuda", source=SOURCE,
        replaces="bowtie_tpu/align/exact.py:142",
        ms=time_ms(lambda: bwt_rows_offsets(fm, top, hit), device, 20),
        plain_ms=k3r_plain_ms,
        **bounds(walk_bytes + _nbytes(fm.offs, top, hit) + 9 * n,
                 walk_steps, walk_steps, walk_words,
                 SECTORS_PER_WALK_STEP * walk_steps + n),
        library_ms=None, library=NO_LIBRARY, max_abs_err=err, match=True,
        rows=n, valid_rows=m)
    emit({"phase": "kernels", "reads": n_reads, "strands": n,
          "index_bytes": fm.nbytes(), "l2_bytes": L2_BYTES,
          "index_fits_l2": fm.nbytes() < L2_BYTES,
          "checks": {k: v["match"] for k, v in out.items()},
          "ms": {k: v["ms"] for k, v in out.items()}})
    return out, launches, (mat_np, lens_np)


DFS_READS = 16384
DFS_L = 40                     # the row width of 36 bp reads (_len_bucket)
THIN_READS = 4096
THIN_STEPS = 1800


def time_once(fn, device):
    """(fn(), its ms): CUDA events around one call behind a spin kernel
    (for the plain versions, whose one run takes seconds); the host clock
    off the card."""
    if device.type != "cuda":
        t = time.perf_counter()
        res = fn()
        return res, 1e3 * (time.perf_counter() - t)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    a.record()
    res = fn()
    b.record()
    b.synchronize()
    return res, a.elapsed_time(b)


def k7_ptxas(name="dfs_machine") -> list:
    """ptxas's lines about K7 (kernels.build keeps its report), or about
    the kernel whose mangled name holds `name`."""
    with open(os.path.join(ROOT, "bowtie_tpu_torch", "csrc", "build",
                           "ptxas.txt")) as f:
        return ptxas_entry(f.read(), name)


BEST_LAUNCHES = ("best_machine", "best_record", "best_pev2")


def machine_ms(fn, iters: int) -> dict:
    """The best-first machine's launch inside fn() alone (K10, K10r,
    K14): CUDA events recorded around the C entry's call, behind a spin
    kernel, so that the wrapper's packing and uploads of the lanes' state
    stay outside; median, min and max of `iters` calls after one
    warm-up."""
    real, times = kernels.launch, []

    def timed(name, *a, **k):
        if name not in BEST_LAUNCHES:
            return real(name, *a, **k)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        s.record()
        real(name, *a, **k)
        e.record()
        times.append((s, e))
    kernels.launch = timed
    try:
        for _ in range(1 + iters):
            fn()
            torch.cuda.synchronize()
    finally:
        kernels.launch = real
    ts = [s.elapsed_time(e) for s, e in times[1:]]
    return dict(ms=statistics.median(ts), ms_min=min(ts), ms_max=max(ts))


def k7_diag(pair, jd, seeds, c0, kw, steps, device, full=True) -> dict:
    """K7's launch against its lanes (utils/kdiag.py lane_stats of the
    per-lane transitions it wrote), with, when `full`, the slowest lane
    alone and its warp's 32 lanes alone, each timed as the launch is
    (median of 5)."""
    st = lane_stats(steps.cpu().numpy())
    if not full:
        return st

    def lanes(lo, hi):
        sub = ({k: v[lo:hi].contiguous() for k, v in jd.items()},
               seeds[lo:hi].contiguous(), c0[lo:hi].contiguous())
        return time_ms(lambda: dfs.run_machine(pair, *sub, **kw), device, 5)

    b, w = st["slowest_lane"], st["slowest_warp"]
    st.update(slowest_lane_ms=lanes(b, b + 1),
              slowest_warp_ms=lanes(w, min(w + 32, len(steps))))
    return st


def thinned_index(idx):
    """idx with only every 256th SA sample kept (offRate + 8)."""
    return idx.with_off_rate(idx.off_rate + 8)


def mm_reads(rng, genome, rep_starts, seg_len, n, path):
    """make_reads' mix with a second mismatch in every fourth read (0, 1
    and 2 mismatches, Ns, repeats), written as FASTQ and read back."""
    codes, lens, *_ = make_reads(rng, genome, rep_starts, seg_len, n)
    rows = np.arange(0, n, 4)
    col = rng.integers(0, READ_LEN, len(rows))
    c = codes[rows, col]
    codes[rows, col] = np.where(c < 4, (c + 1) % 4, c)
    write_fastq(path, codes, lens)
    return list(ReadSource([path]).records())


def check_mm_hits(hits, genome_chars):
    """Every hit equals its reference substring (the read, or its reverse
    complement on -), except at exactly the reported mismatch positions,
    where the reported reference characters stand."""
    for h in hits:
        n = len(h.read.seq)
        aligned = h.read.seq if h.fw else revcomp(h.read.seq)
        ref = genome_chars[h.toff:h.toff + n]
        mm = {(p if h.fw else n - 1 - p): bytes([c]).upper()
              for p, c in h.mms}
        want = bytes(b"".join(mm.get(i, aligned[i:i + 1])
                              for i in range(n)))
        require(ref == want and all(aligned[i:i + 1] != r
                                    for i, r in mm.items()),
                f"hit of {h.read.name!r} at {h.toff} "
                f"({'+' if h.fw else '-'}, mms {h.mms}) does not match "
                "the reference")


def k7_bytes(work, qqp, seeds, c0, out) -> int:
    """What the machine must read and write: the distinct index items
    its plain version counted (a 16-byte occ checkpoint and a 32-byte
    bwt block per 128 rows, 4-byte SA or sampled-SA entries, an 8-byte
    ftab_hi/ftab_lo pair per ftab offset), the job field rows it loaded
    and the by-depth rows it read, the seeds and counts, and every
    output as the kernel writes it (int32)."""
    return (16 * work["occ_entries"] + 32 * work["bwt_blocks"]
            + 4 * work["sa_entries"] + 8 * work["ftab_entries"]
            + 4 * dfs.NJF * work["job_fields"]
            + qqp.shape[2] * work["job_rows"] + _nbytes(seeds, c0)
            + 4 * sum(out[k].numel() for k in dfs.OUT_KEYS))


def k8_bytes(out, nh_eff) -> int:
    """What the packing must read and write: each counted hit row
    (HIT_W words) and partial row (PART_W words) once in and once out,
    and per lane nhits, overflow (1 byte) and npart in, nh_eff out."""
    rows = (int(nh_eff.sum()) * dfs.HIT_W
            + int(out["npart"].sum()) * dfs.PART_W)
    return 2 * 4 * rows + (4 + 1 + 4 + 4) * nh_eff.numel()


def check_with_oracle(reads, lanes, bounds_l, mk, out, seeds, oracle,
                      policy):
    """The kernel's result on each of `lanes`, finished by the policy as
    the aligner finishes it, must be the host oracle's for that read."""
    count, seed = out["count"].tolist(), seeds.tolist()
    for b in lanes:
        got = policy.finish([mk(reads[b], j) for j in
                             range(bounds_l[b], bounds_l[b + 1])],
                            count[b], seed[b])
        require(result_key(got) == result_key(oracle.align_read(reads[b])),
                f"lane {b} ({reads[b].name!r}): the kernel's result "
                "differs from the host oracle's")


def dfs_case(name, pair, reads, v, n_k, m_max, max_steps, device,
             genome_chars, timed, golden):
    """K6, K7 and K8 on one job table, each held to its plain version
    on the card; K7 lane for lane wherever the plain version finished
    within max_steps, and on the lanes past that budget that it finished
    itself to the host oracle over `golden` (the budget rule,
    align/dfs_device.py)."""
    jobs, J = build_v_jobs_vec(reads, v, False, False, DFS_L)
    fc = pair.ftab_chars
    B = len(reads)
    base = [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (
        np.stack([jobs[f] for f in dfs.JOB_FIELDS], -1).astype(np.int32),
        jobs["base_codes"], jobs["base_qual"], jobs["base_plen"])]
    scal, qqp = dfs.derive_rows(*base, fc)
    (pscal, pqqp), k6_plain_ms = time_once(
        lambda: dfs.derive_rows_plain(*base, fc), device)
    err6 = max_abs_err([(scal, pscal), (qqp, pqqp)])
    require(err6 == 0, f"{name}: K6 disagrees with its plain version")
    jd = {"scal": scal, "qqp": qqp}
    seeds = torch.from_numpy(
        fill_seed_caches(reads, 0).astype(np.int64)).to(device)
    c0 = torch.zeros(B, dtype=torch.int32, device=device)
    kw = dict(n_k=n_k, m_max=m_max, max_steps=max_steps)
    out, steps = dfs.run_machine_lanes(pair, jd, seeds, c0, **kw)
    transitions = steps.max()
    # timed, the one plain run also counts the work the bounds price
    work = {} if timed else None
    (pout, iters), k7_plain_ms = time_once(
        lambda: dfs.run_machine_plain(pair, jd, seeds, c0, work=work, **kw),
        device)
    done = pout["mode"] == dfs.M_DONE
    err7 = max_abs_err([(a[done], pout[k][done]) for k, a in out.items()
                        if k in dfs.OUT_KEYS])
    require(err7 == 0, f"{name}: K7 disagrees with its plain version on "
            "lanes the plain version finished")
    hits, parts, nh_eff = dfs.pack_hits(out)
    ph, pp, pn = dfs.pack_hits_plain(out)
    err8 = max_abs_err([(hits, ph), (parts, pp), (nh_eff, pn)])
    require(err8 == 0, f"{name}: K8 disagrees with its plain version")
    bounds_l, mk = dfs.decode_hit_cols(hits.cpu().numpy(),
                                       nh_eff.cpu().numpy())
    decoded = [mk(reads[b], j) for b in range(B)
               for j in range(bounds_l[b], bounds_l[b + 1])]
    check_mm_hits(decoded, genome_chars)
    past = (~done & (out["mode"] == dfs.M_DONE) & ~out["overflow"])
    past = past.nonzero()[:, 0].tolist()
    t = time.time()
    policy = KPolicy(khits=INF if n_k == dfs.INF32 else n_k,
                     mhits=INF if m_max == dfs.INF32 else m_max)
    check_with_oracle(reads, past, bounds_l, mk, out, seeds,
                      OracleAligner(*golden, policy, v=v), policy)
    row = dict(reads=B, jobs=J, n_k=n_k, m_max=m_max, dense=pair.dense,
               off_rate=pair.fw.off_rate, max_steps=max_steps,
               plain_iterations=int(iters),
               kernel_max_transitions=int(transitions),
               budget_lanes=int((~done).sum()),
               kernel_budget_lanes=int((out["mode"] != dfs.M_DONE).sum()),
               overflow_lanes=int(out["overflow"].sum()),
               oracle_checked_lanes=len(past), oracle_s=time.time() - t,
               hits=len(decoded),
               hits_with_mismatches=sum(1 for h in decoded if h.mms),
               k6_plain_ms=k6_plain_ms, k7_plain_ms=k7_plain_ms,
               max_abs_err=max(err6, err7, err8),
               k7_ms=time_ms(lambda: dfs.run_machine(pair, jd, seeds, c0,
                                                     **kw), device, 10),
               k7_lanes=k7_diag(pair, jd, seeds, c0, kw, steps, device,
                                full=timed))
    if not timed:
        return row, None
    half = ({k: v[:B // 2].contiguous() for k, v in jd.items()},
            seeds[:B // 2].contiguous(), c0[:B // 2].contiguous())
    row["work"] = work
    nbytes6 = _nbytes(*base, scal, qqp)
    nbytes7 = k7_bytes(work, qqp, seeds, c0, out)
    nbytes8 = k8_bytes(out, nh_eff)
    slot = torch.arange(dfs.H_MAX, device=device)
    hits3 = out["hits"].view(B, dfs.H_MAX, dfs.HIT_W)
    stats = {
        "K6": dict(
            name="K6 derive_rows", route="cuda", source=JOBS_SOURCE,
            replaces="bowtie_tpu/align/dfs_device.py:496",
            ms=time_ms(lambda: dfs.derive_rows(*base, fc), device, 20),
            plain_ms=k6_plain_ms,
            **bounds(nbytes6, 0, 0, 0, nbytes6 // SECTOR),
            library_ms=None, library=NO_LIBRARY_K6, max_abs_err=err6,
            rows=B * J),
        "K7": dict(
            name="K7 dfs_machine (K5 rank4/lf4pair inlined)", route="cuda",
            source=DFS_SOURCE,
            replaces="bowtie_tpu/align/dfs_device.py:1484 (K5: :261, :303)",
            ms=row["k7_ms"],
            plain_ms=k7_plain_ms, plain_with_work_count=True,
            **bounds(nbytes7, work["rank_codes"], work["walk_steps"],
                     work["word_codes"],
                     2 * work["rank_ends"] + 2 * work["walk_steps"]
                     + work["sa_loads"]),
            library_ms=None, library=NO_LIBRARY_K7, max_abs_err=err7,
            lanes=B, rank_ends=work["rank_ends"],
            sa_loads=work["sa_loads"], bytes=nbytes7,
            ms_at_half_lanes=time_ms(
                lambda: dfs.run_machine(pair, *half, **kw), device, 10),
            transitions=row["k7_lanes"], ptxas=k7_ptxas()),
        "K8": dict(
            name="K8 dfs_pack", route="cuda", source=DFS_SOURCE,
            replaces="bowtie_tpu/align/dfs_device.py:1953",
            ms=time_ms(lambda: dfs.pack_hits(out), device, 20),
            plain_ms=time_once(lambda: dfs.pack_hits_plain(out),
                               device)[1],
            **bounds(nbytes8, 0, 0, 0, -(-nbytes8 // SECTOR)),
            library_ms=time_ms(lambda: hits3[slot < nh_eff[:, None]],
                               device, 20),
            library="hits[slot < nhits] (boolean index)",
            max_abs_err=err8, rows=int(hits.shape[0]), bytes=nbytes8,
            launches_per_call=counted(lambda: dfs.pack_hits(out),
                                      device)[1]["dfs_pack"],
            host_syncs=host_syncs(lambda: dfs.pack_hits(out)),
            library_host_syncs=host_syncs(
                lambda: hits3[slot < nh_eff[:, None]])),
    }
    return row, stats


def phase_dfs(rng, work, device, genome, rep_starts, seg_len, idx, idx_bw,
              golden):
    """The DFS machine's kernels against their plain versions on the
    card: -v 1 -k 1, -v 2 -a -m 3 and -v 2 -a on the dense pair, and
    -v 1 -k 1 on the pair thinned to offRate 13 (walk-left)."""
    genome_chars = CHARS[genome].tobytes()
    reads = mm_reads(rng, genome, rep_starts, seg_len, DFS_READS,
                     os.path.join(work, "dfs.fq"))
    dense = dfs.build_fmpair(idx, idx_bw, device, dense_sa=True)
    thin = dfs.build_fmpair(thinned_index(idx), thinned_index(idx_bw),
                            device, dense_sa=False)
    cases, stats = {}, None
    for name, pair, rds, v, n_k, m_max, steps, timed in (
            ("v1_k1_dense", dense, reads, 1, 1, dfs.INF32, 20000, False),
            ("v2_a_m3_dense", dense, reads, 2, dfs.INF32, 3, 20000, True),
            ("v2_a_dense", dense, reads, 2, dfs.INF32, dfs.INF32, 20000,
             False),
            ("v1_k1_offrate13_walk", thin, reads[:THIN_READS], 1, 1,
             dfs.INF32, THIN_STEPS, False)):
        t = time.time()
        cases[name], st = dfs_case(name, pair, rds, v, n_k, m_max, steps,
                                   device, genome_chars, timed, golden)
        cases[name]["wall_s"] = time.time() - t
        stats = st or stats
    require(cases["v2_a_dense"]["overflow_lanes"] > 0,
            "plain -a made no lane overflow H_MAX")
    walk = cases["v1_k1_offrate13_walk"]
    require(0 < walk["budget_lanes"] < THIN_READS
            and walk["oracle_checked_lanes"] > 0,
            "offRate 13: want some lanes past the plain budget, not all, "
            "and some of them finished by K7")
    stats["K7"]["ms_by_case"] = {k: c["k7_ms"] for k, c in cases.items()}
    emit({"phase": "dfs", "cases": cases,
          "ms": {k: v["ms"] for k, v in stats.items()}})
    return stats


def write_fastq(path, codes, lens, quals=None):
    """FASTQ of codes [n, L] (lens [n]); quals [n, L] Phred values, or
    Phred 40 ('I') throughout."""
    with open(path, "wb") as f:
        for i, (row, ln) in enumerate(zip(codes, lens)):
            s = CHARS[row[:ln]].tobytes()
            q = (b"I" * ln if quals is None
                 else (quals[i, :ln] + 33).astype(np.uint8).tobytes())
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, q))


def revcomp(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGTN", b"TGCAN"))


def check_hits(hits, genome_chars, reads_by_name):
    """Every hit (name, minus, off) must be its read (or the read's
    reverse complement on -) at that genome offset."""
    for name, minus, off in hits:
        seq = reads_by_name[name]
        want = revcomp(seq) if minus else seq
        require(genome_chars[off:off + len(seq)] == want,
                f"hit of {name!r} at {off} ({'-' if minus else '+'}) is "
                "not its reference substring")


def parse_verbose(path):
    with open(path, "rb") as f:
        for line in f:
            p = line.split(b"\t")
            yield p[0], p[1] == b"-", int(p[3])


def parse_sam(path):
    """-> (hits [(name, minus, off)], records, unaligned records)."""
    hits, nrec, nun = [], 0, 0
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            p = line.split(b"\t")
            nrec += 1
            flag = int(p[1])
            if flag & 4:
                nun += 1
                continue
            hits.append((p[0], bool(flag & 16), int(p[3]) - 1))
    return hits, nrec, nun


def run_cli(args, device):
    err = io.StringIO()
    t = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args, device=device)
    sync(device)
    wall = time.time() - t
    require(rc == 0, f"cli {args} exited {rc}: {err.getvalue()}")
    return wall, err.getvalue()


def counted(fn, device):
    """fn() with the launch counters zeroed just before it; -> (fn's
    result, the launches it made)."""
    kernels.reset_launches()
    res = fn()
    if device.type == "cuda":
        sync_all()
    return res, dict(kernels.LAUNCHES)


def records_of(path, names):
    """Header lines but @PG (it holds the argv), and the records of the
    reads in `names`, in file order."""
    with open(path, "rb") as f:
        return [ln for ln in f if not ln.startswith(b"@PG")
                and (ln.startswith(b"@") or ln.split(b"\t", 1)[0] in names)]


CPU_SLICE = 1000


def phase_cli(rng, work, device, genome, rep_starts, seg_len, base, idx,
              fm_sa, n_reads, gpu):
    codes, lens, kind, _pos, _strand = make_reads(
        rng, genome, rep_starts, seg_len, n_reads)
    reads = os.path.join(work, "reads.fq")
    write_fastq(reads, codes, lens)
    head = os.path.join(work, "reads_head.fq")
    write_fastq(head, codes[:CPU_SLICE], lens[:CPU_SLICE])
    names = [b"r%d" % i for i in range(n_reads)]
    head_names = set(names[:CPU_SLICE])
    reads_by_name = {nm: CHARS[row[:ln]].tobytes()
                     for nm, row, ln in zip(names, codes, lens)}
    genome_chars = CHARS[genome].tobytes()
    exact = (kind == KINDS.index("exact")) | (kind == KINDS.index("repeat"))
    cpu = torch.device("cpu")

    def same_as_cpu(args, out):
        """The card's records of the first CPU_SLICE reads must be the
        CPU's (plain versions) for those reads, byte for byte.  -> (the
        records compared, the CPU run's seconds)."""
        cpu_out = out + ".cpu"
        cpu_s = run_cli(args + ["-x", base, head, cpu_out], cpu)[0]
        want = records_of(cpu_out, head_names)
        got = records_of(out, head_names)
        require(got == want, f"cli {args}: card and CPU records of the "
                f"first {CPU_SLICE} reads differ")
        return len(want), cpu_s

    k1_args = ["-v", "0", "-k", "1"]
    out1 = os.path.join(work, "k1.txt")
    (wall1, err1), launches1 = counted(
        lambda: run_cli(k1_args + ["-x", base, reads, out1], device), device)
    require(launches1["one_row"] > 0, f"-k 1 run launched {launches1}")
    hits1 = list(parse_verbose(out1))
    check_hits(hits1, genome_chars, reads_by_name)
    aligned1 = {h[0] for h in hits1}
    missing = [nm for nm, e in zip(names, exact) if e and nm not in aligned1]
    require(not missing, f"{len(missing)} planted exact reads did not "
            f"align, e.g. {missing[:3]}")
    cpu_lines1, cpu_s1 = same_as_cpu(k1_args, out1)

    a_args = ["-v", "0", "-a", "-m", "3", "-S", "--batch-size", "65536"]
    out2 = os.path.join(work, "a_m3.sam")
    # K3 walk's launches in this run kept: its rows and what it returned
    seen, real = [], tpipe.resolve_rows

    def keep(f, rows):
        off, ok = real(f, rows)
        seen.append((f, rows.clone(), off.clone(), ok.clone()))
        return off, ok
    tpipe.resolve_rows = keep
    try:
        (wall2, err2), launches2 = counted(
            lambda: run_cli(a_args + ["-x", base, reads, out2], device),
            device)
    finally:
        tpipe.resolve_rows = real
    # ... each held to the plain version on the same rows
    require(len(seen) == launches2["resolve_rows_walk"] > 0,
            f"-a -m 3 run's K3 walk launches: {len(seen)} kept")
    k3_batches = []
    for f, rows, off, ok in seen:
        walk = torch.zeros(2, rows.numel(), dtype=torch.int64, device=device)
        (poff, pok), plain_ms = time_once(
            lambda: resolve_rows_plain(f, rows, walk), device)
        err = max_abs_err([(off, poff), (ok, pok)])
        require(err == 0, f"K3 walk on the CLI's -a batch disagrees with "
                f"its plain version by {err}")
        k3_batches.append(dict(rows=rows.numel(),
                               walk_steps=int(walk[0].sum()),
                               max_walk=int(walk[0].max()),
                               plain_ms=plain_ms, max_abs_err=err,
                               match=True))
    del seen
    require(launches2["exact_ranges"] > 0
            and launches2["resolve_rows_walk"] > 0,
            f"-a -m 3 run launched {launches2}")
    hits2, nrec2, nun2 = parse_sam(out2)
    check_hits(hits2, genome_chars, reads_by_name)
    cpu_lines2, cpu_s2 = same_as_cpu(a_args, out2)

    # the same alignment through the library on the dense-SA index
    aligner = ExactAligner(fm_sa, idx, KPolicy(khits=INF, mhits=3))

    def library_run():
        hits = []
        for batch in ReadSource([reads]).batches(65536):
            for read, res in zip(batch, aligner.align_batch(batch)):
                hits.extend((read.name, not h.fw, h.toff) for h in res.hits)
        return hits

    t = time.time()
    hits3, launches3 = counted(library_run, device)
    wall3 = time.time() - t
    require(launches3["resolve_rows_sa"] > 0, "dense run launched no K3 SA")
    require(hits3 == hits2, "dense-SA alignments differ from the CLI's")
    runs = {"cli -v 0 -k 1": launches1, "cli -v 0 -a -m 3 -S": launches2,
            "library ExactAligner -a -m 3, dense SA": launches3}
    emit({"phase": "cli", "reads": n_reads, "gpu": gpu,
          "k1": {"wall_s": wall1, "reads_per_s": n_reads / wall1,
                 "hits": len(hits1), "launches": launches1,
                 "cpu_equal_lines": cpu_lines1, "cpu_slice_s": cpu_s1,
                 "summary": err1.strip().splitlines()},
          "a_m3_S": {"wall_s": wall2, "reads_per_s": n_reads / wall2,
                     "records": nrec2, "unaligned": nun2,
                     "hits": len(hits2), "launches": launches2,
                     "k3_walk_batches": k3_batches,
                     "cpu_equal_lines": cpu_lines2, "cpu_slice_s": cpu_s2,
                     "summary": err2.strip().splitlines()},
          "a_m3_dense_sa_library": {"wall_s": wall3,
                                    "reads_per_s": n_reads / wall3,
                                    "hits": len(hits3),
                                    "launches": launches3},
          "cpu_slice_reads": CPU_SLICE,
          "planted_exact_reads": int(exact.sum())})
    return runs, k3_batches


V_SLICE = 400
# reads of the -v 0 and -v 1/2 CLI phases (cli, cli_v): cut from 200,000
# when the -n phases came, to keep the script near half its time limit;
# those of the -n CLI phase (cli_n) likewise when the best-first phases
# came, and the CPU slices of cli_v and cli_n from 2,000 reads to 1,000;
# all the CLI phases' reads and pairs halved or so when a host slower
# than earlier ones ran the whole script past 1,250 s
CLI_READS = 50_000
CLI_N_READS = 50_000


def profiled(fn):
    """(fn(), device busy seconds): fn under torch.profiler, busy being
    the sum of device time over all kernels and copies."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = fn()
    return res, sum(e.self_device_time_total
                    for e in prof.key_averages()) / 1e6


def result_key(r):
    return ([(h.fw, h.tidx, h.toff, h.oms, h.stratum, h.cost,
              tuple(h.mms)) for h in r.hits],
            r.maxed, r.nvalid, r.sampled, r.nbuffered)


def phase_cli_v(rng, work, device, genome, rep_starts, seg_len, base, idx,
                idx_bw, golden, n_reads, gpu):
    """-v 1 -k 1 (verbose) and -v 2 -a -m 3 -S through the CLI on the
    card, each counted from zero and traced for the device's busy time;
    the records of the first V_SLICE reads must equal the CPU CLI's, and
    the library aligner's results on them the host oracle's."""
    reads = os.path.join(work, "v_reads.fq")
    mm_reads(rng, genome, rep_starts, seg_len, n_reads, reads)
    head = os.path.join(work, "v_head.fq")
    with open(reads, "rb") as f, open(head, "wb") as g:
        g.writelines(f.readlines()[:4 * V_SLICE])
    head_reads = list(ReadSource([head]).records())
    names = {r.name for r in head_reads}
    runs, rows = {}, {}
    for tag, args, v, policy in (
            ("-v 1 -k 1", ["-v", "1", "-k", "1"], 1, KPolicy(khits=1)),
            ("-v 2 -a -m 3 -S", ["-v", "2", "-a", "-m", "3", "-S"], 2,
             KPolicy(khits=INF, mhits=3))):
        out = os.path.join(work, f"v{v}.out")
        dfs.FALLBACKS["lanes"] = 0
        ((wall, err), busy), launches = counted(lambda: profiled(
            lambda: run_cli(args + ["-x", base, reads, out], device)),
            device)
        fallbacks = dfs.FALLBACKS["lanes"]
        require(all(launches[k] > 0 for k in ("derive_rows", "dfs_machine",
                                               "dfs_pack")),
                f"cli {tag} launched {launches}")
        cpu_out = out + ".cpu"
        t = time.time()
        run_cli(args + ["-x", base, head, cpu_out], torch.device("cpu"))
        cpu_s = time.time() - t
        want = records_of(cpu_out, names)
        require(records_of(out, names) == want, f"cli {tag}: card and CPU "
                f"records of the first {V_SLICE} reads differ")
        lib = dfs.DeviceDFSAligner(idx, idx_bw, policy, v=v, device=device)
        got = [result_key(r) for r in lib.align_batch(head_reads)]
        t = time.time()
        ora = OracleAligner(*golden, policy, v=v)
        require(got == [result_key(r) for r in ora.align_batch(head_reads)],
                f"{tag}: the card's results on the first {V_SLICE} reads "
                "differ from the host oracle's")
        rows[tag] = {"wall_s": wall, "reads_per_s": n_reads / wall,
                     "device_busy_s": busy, "device_busy_share": busy / wall,
                     "launches": launches, "fallbacks": fallbacks,
                     "cpu_equal_lines": len(want), "cpu_slice_s": cpu_s,
                     "oracle_s": time.time() - t,
                     "summary": err.strip().splitlines()}
        runs["cli " + tag] = launches
    emit({"phase": "cli_v", "reads": n_reads, "gpu": gpu,
          "slice_reads": V_SLICE, "runs": rows})
    return runs


N_READS = 16384
# (name, -n, -l, -e, Maq rounding, -k, -m)
N_POLICIES = (("-n 2 -k 1", 2, 28, 70, True, 1, dfs.INF32),
              ("-n 3 -l 20 -a -m 3", 3, 20, 70, True, dfs.INF32, 3),
              ("-n 1 --nomaqround -e 40", 1, 28, 40, False, 1, dfs.INF32))
N_MAXBTS = 125                 # -n's default backtrack ceiling
N_STEPS = 60000                # -n's step budget per launch


def n_reads(rng, genome, rep_starts, seg_len, n, path):
    """mm_reads' mix with three mismatches in every third read, and
    qualities drawn from Phred 2-40 (so that -e and Maq rounding both
    decide), written as FASTQ and read back."""
    codes, lens, *_ = make_reads(rng, genome, rep_starts, seg_len, n)
    rows = np.arange(0, n, 4)
    col = rng.integers(0, READ_LEN, len(rows))
    c = codes[rows, col]
    codes[rows, col] = np.where(c < 4, (c + 1) % 4, c)
    rows = np.arange(0, n, 3)
    cols = np.argsort(rng.random((len(rows), READ_LEN)), 1)[:, :3]
    c = codes[rows[:, None], cols]
    codes[rows[:, None], cols] = np.where(
        c < 4, (c + rng.integers(1, 4, c.shape)) % 4, c)
    quals = rng.integers(2, 41, (n, READ_LEN))
    write_fastq(path, codes, lens, quals)
    return list(ReadSource([path]).records())


def k9_bytes(out_a, gated, base_plen, scal_b) -> int:
    """What K9 must read and write: per lane result, mode, npart and plen
    (4 B each) and overflow and gated (1 B each); for each lane that takes
    jobs, every partial row it counted (job, n, pos[3], refc[3]: 32 B) and
    the quality byte at each of its mutations; the 1 KB Maq table; and the
    whole [B, J, NJF] int32 table it writes."""
    B = base_plen.shape[0]
    active = ((out_a["result"] == 0) & ~out_a["overflow"]
              & (out_a["mode"] == dfs.M_DONE) & ~gated)
    slot = torch.arange(dfs.P_MAX, device=base_plen.device)[None, :]
    counted = (slot < out_a["npart"][:, None]) & active[:, None]
    return (18 * B + 32 * int(counted.sum())
            + int(out_a["part_n"][counted].sum()) + 4 * 256
            + 4 * scal_b.numel())


def n_case(name, pair, reads, n, s, qt, maq, n_k, m_max, device,
           genome_chars):
    """Launch A (K6, K7) on the card, then K9 and launch B's K7 each held
    exactly to its plain version on the card, on the same inputs; K8 on
    both launches, and every hit checked against the genome."""
    fc = pair.ftab_chars
    B = len(reads)
    L = dfs._len_bucket(max(READ_LEN, s))
    jobs, J_A, gated_np, jrc, _ = build_n_jobs_a_vec(
        reads, n, s, qt, N_MAXBTS, maq, False, False, L)
    base = [torch.from_numpy(np.ascontiguousarray(jobs[k])).to(device)
            for k in ("base_codes", "base_qual", "base_plen")]
    gated = torch.from_numpy(gated_np).to(device)
    seeds = torch.from_numpy(
        fill_seed_caches(reads, 0).astype(np.int64)).to(device)
    c0 = torch.zeros(B, dtype=torch.int32, device=device)
    kw = dict(n_k=n_k, m_max=m_max, max_steps=N_STEPS)
    out_a, _ = dfs.run_machine(pair, dfs.upload_jobs(jobs, fc, device),
                               seeds, c0, **kw)
    qr = torch.from_numpy(QUAL_ROUNDS.astype(np.int32)).to(device)
    bargs = (out_a, gated, base[1], base[2], qr)
    bkw = dict(J=nd.J_B, jrc=jrc, n=n, s=s, qt=qt, maxbts=N_MAXBTS, maq=maq,
               norc=False, nofw=False)
    scal_b = nd.derive_b_jobs(*bargs, **bkw)
    pscal_b, k9_plain_ms = time_once(
        lambda: nd.derive_b_jobs_plain(*bargs, **bkw), device)
    err9 = max_abs_err([(scal_b, pscal_b)])
    require(err9 == 0, f"{name}: K9 disagrees with its plain version")
    scal6, qqp6 = dfs.derive_rows(scal_b, *base, fc)
    jb = {"scal": scal6, "qqp": qqp6}
    out_b, steps_b = dfs.run_machine_lanes(pair, jb, seeds, out_a["count"],
                                           **kw)
    transitions = steps_b.max()
    (pout_b, iters), k7_plain_ms = time_once(
        lambda: dfs.run_machine_plain(pair, jb, seeds, out_a["count"], **kw),
        device)
    require(bool((pout_b["mode"] == dfs.M_DONE).all()),
            f"{name}: the plain launch B ran past {N_STEPS} iterations")
    err7 = max_abs_err([(a, pout_b[k]) for k, a in out_b.items()
                        if k in dfs.OUT_KEYS])
    require(err7 == 0, f"{name}: launch B's K7 disagrees with its plain "
            "version")
    decoded = []
    for out in (out_a, out_b):
        hits, _parts, nh_eff = dfs.pack_hits(out)
        bounds_l, mk = dfs.decode_hit_cols(hits.cpu().numpy(),
                                           nh_eff.cpu().numpy())
        decoded.append([mk(reads[b], j) for b in range(B)
                        for j in range(bounds_l[b], bounds_l[b + 1])])
    check_mm_hits(decoded[0] + decoded[1], genome_chars)
    valid = scal_b[..., dfs.JOB_FIELDS.index("valid")]
    row = dict(reads=B, jobs_a=J_A, jobs_b=nd.J_B, n=n, seed_len=s, e=qt,
               maq_round=maq, n_k=n_k, m_max=m_max,
               gated_lanes=int(gated.sum()),
               lanes_with_partials=int((out_a["npart"] > 0).sum()),
               partials=int(out_a["npart"].sum()),
               lanes_with_b_jobs=int((valid.sum(1) > 0).sum()),
               b_jobs_valid=int(valid.sum()),
               b_jobs_premut=int((scal_b[..., dfs.JOB_FIELDS.index(
                   "npremut")] > 0).sum()),
               overflow_a=int(out_a["overflow"].sum()),
               overflow_b=int(out_b["overflow"].sum()),
               hits_a=len(decoded[0]), hits_b=len(decoded[1]),
               hits_b_with_mismatches=sum(1 for h in decoded[1] if h.mms),
               plain_b_iterations=int(iters),
               kernel_b_max_transitions=int(transitions),
               k9_plain_ms=k9_plain_ms, k7_b_plain_ms=k7_plain_ms,
               max_abs_err=max(err9, err7),
               k7_b_ms=time_ms(lambda: dfs.run_machine(
                   pair, jb, seeds, out_a["count"], **kw), device, 10),
               k7_b_lanes=lane_stats(steps_b.cpu().numpy()))
    nbytes9 = k9_bytes(out_a, gated, base[2], scal_b)
    stat = dict(
        name="K9 derive_b_jobs", route="cuda", source=JOBS_SOURCE,
        replaces="bowtie_tpu/align/n_device.py:85",
        ms=time_ms(lambda: nd.derive_b_jobs(*bargs, **bkw), device, 20),
        plain_ms=k9_plain_ms,
        **bounds(nbytes9, 0, 0, 0, -(-nbytes9 // SECTOR)),
        library_ms=None, library=NO_LIBRARY_K9, max_abs_err=err9,
        lanes=B, bytes=nbytes9, policy=name)
    return row, stat


def jobs_cli_shape(pair, reads, device):
    """K9 and K6 at the CLI's shape: -n 2 -k 1 launch A on one CLI batch
    (8,192 reads, L 40) on the card, then K9 (8,192 lanes) and K6 on the
    launch-B table it builds (8,192 x 36 rows, the largest K6 launch of
    any CLI run), each held exactly to its plain version on the same
    inputs and timed (median of 20), with its bytes, bound, ptxas lines,
    local bytes and launch shape.  -> {"K6": ..., "K9": ...}: the
    kernels line's rows."""
    fc = pair.ftab_chars
    B = len(reads)
    jobs, _, gated_np, jrc, _ = build_n_jobs_a_vec(
        reads, 2, 28, 70, N_MAXBTS, True, False, False, DFS_L)
    base = [torch.from_numpy(np.ascontiguousarray(jobs[k])).to(device)
            for k in ("base_codes", "base_qual", "base_plen")]
    seeds = torch.from_numpy(
        fill_seed_caches(reads, 0).astype(np.int64)).to(device)
    out_a, _ = dfs.run_machine(
        pair, dfs.upload_jobs(jobs, fc, device), seeds,
        torch.zeros(B, dtype=torch.int32, device=device), n_k=1,
        m_max=dfs.INF32, max_steps=N_STEPS)
    qr = torch.from_numpy(QUAL_ROUNDS.astype(np.int32)).to(device)
    bargs = (out_a, torch.from_numpy(gated_np).to(device), base[1],
             base[2], qr)
    bkw = dict(J=nd.J_B, jrc=jrc, n=2, s=28, qt=70, maxbts=N_MAXBTS,
               maq=True, norc=False, nofw=False)
    scal_b = nd.derive_b_jobs(*bargs, **bkw)
    pscal_b, k9_plain_ms = time_once(
        lambda: nd.derive_b_jobs_plain(*bargs, **bkw), device)
    err9 = max_abs_err([(scal_b, pscal_b)])
    require(err9 == 0, "K9 at the CLI's shape disagrees with its plain "
            "version")
    k6in = (scal_b, *base, fc)
    scal6, qqp6 = dfs.derive_rows(*k6in)
    (pscal6, pqqp6), k6_plain_ms = time_once(
        lambda: dfs.derive_rows_plain(*k6in), device)
    err6 = max_abs_err([(scal6, pscal6), (qqp6, pqqp6)])
    require(err6 == 0, "K6 at the CLI's shape disagrees with its plain "
            "version")
    local = dfs.jobs_local_bytes()
    require(all(v == 0 for v in local.values()),
            f"K6/K9 have a stack: {local} local bytes")
    nbytes6 = _nbytes(*k6in[:4], scal6, qqp6)
    nbytes9 = k9_bytes(out_a, bargs[1], base[2], scal_b)
    valid = scal_b[..., dfs.JOB_FIELDS.index("valid")]
    return {
        "K6": dict(
            name="K6 derive_rows", route="cuda", source=JOBS_SOURCE,
            replaces="bowtie_tpu/align/dfs_device.py:496",
            ms=time_ms(lambda: dfs.derive_rows(*k6in), device, 20),
            plain_ms=k6_plain_ms,
            **bounds(nbytes6, 0, 0, 0, nbytes6 // SECTOR),
            library_ms=None, library=NO_LIBRARY_K6, max_abs_err=err6,
            policy="-n 2 -k 1 launch B, one CLI batch", lanes=B,
            jobs=nd.J_B, L=DFS_L, rows=B * nd.J_B, bytes=nbytes6,
            shape=dfs.derive_rows_shape(B, nd.J_B),
            ptxas=k7_ptxas("derive_rows"),
            local_bytes=local["derive_rows"]),
        "K9": dict(
            name="K9 derive_b_jobs", route="cuda", source=JOBS_SOURCE,
            replaces="bowtie_tpu/align/n_device.py:85",
            ms=time_ms(lambda: nd.derive_b_jobs(*bargs, **bkw), device, 20),
            plain_ms=k9_plain_ms,
            **bounds(nbytes9, 0, 0, 0, -(-nbytes9 // SECTOR)),
            library_ms=None, library=NO_LIBRARY_K9, max_abs_err=err9,
            policy="-n 2 -k 1, one CLI batch", lanes=B, jobs=nd.J_B,
            valid_jobs=int(valid.sum()), bytes=nbytes9,
            shape=nd.derive_b_jobs_shape(B, nd.J_B),
            ptxas=k7_ptxas("derive_b_jobs"),
            local_bytes=local["derive_b_jobs"])}


def phase_n(rng, work, device, genome, rep_starts, seg_len, idx, idx_bw):
    """-n's launch B on the card: K9 and launch B's K7 held to their
    plain versions under -n 2 -k 1, -n 3 -l 20 -a -m 3 and -n 1
    --nomaqround -e 40; K9 timed on the first; K9 and K6 at the CLI's
    shape (jobs_cli_shape)."""
    genome_chars = CHARS[genome].tobytes()
    reads = n_reads(rng, genome, rep_starts, seg_len, N_READS,
                    os.path.join(work, "n.fq"))
    pair = dfs.build_fmpair(idx, idx_bw, device, dense_sa=True)
    cases, stat = {}, None
    for name, n, s, qt, maq, n_k, m_max in N_POLICIES:
        t = time.time()
        cases[name], st = n_case(name, pair, reads, n, s, qt, maq, n_k,
                                 m_max, device, genome_chars)
        cases[name]["wall_s"] = time.time() - t
        stat = stat or st
    require(all(c["b_jobs_premut"] > 0 for c in cases.values()),
            "a policy derived no extension job")
    shape = jobs_cli_shape(pair, reads[:CLI_BATCH], device)
    shape["K9"]["at_16k_lanes"] = {k: stat[k] for k in (
        "ms", "plain_ms", "bound_ms", "bytes", "lanes", "policy")}
    emit({"phase": "n", "cases": cases, "ms": {"K9": stat["ms"]},
          "cli_shape": shape})
    return shape, {k: c["k7_b_ms"] for k, c in cases.items()}


GOLD = os.path.join(ROOT, "tests", "golden", "small_index", "small_oracle")
GOLD_L = os.path.join(ROOT, "tests", "golden", "small_index_l",
                      "small_oracle")


def gold_reads(rng, path, n=400):
    """Seeded 30-40 bp reads of the in-repo small genome (0-2
    mismatches, half reverse complemented) and its exact 36-mers whose
    last ftabChars bases name an escaped ftab entry of the .ebwtl index."""
    refs = unpack_reference(*read_bitpair_reference(GOLD))
    out = []
    for k in range(n):
        r = refs[k % len(refs)]
        ln = int(rng.integers(30, 41))
        p = int(rng.integers(0, len(r) - ln))
        q = np.minimum(r[p:p + ln], 4).astype(np.uint8)
        for _ in range(k % 3):
            q[int(rng.integers(ln))] = rng.integers(4)
        if k % 2:
            q = COMP[q[::-1]]
        out.append((b"g%d" % k, q, rng.integers(2, 41, ln)))
    idx = read_ebwt(GOLD_L)
    esc = set(np.nonzero(idx.ftab > np.uint64(idx.length))[0].tolist())
    fc, g = idx.ftab_chars, refs[0]
    weights = 4 ** np.arange(fc - 1, -1, -1)
    for p in range(len(g) - READ_LEN):
        q = g[p:p + READ_LEN]
        foff = int((q[READ_LEN - fc:] * weights).sum())
        if (q < 4).all() and (foff in esc or foff + 1 in esc):
            out.append((b"esc%d" % p, q.astype(np.uint8),
                        np.full(READ_LEN, 40)))
    with open(path, "wb") as f:
        for name, q, ph in out:
            f.write(b"@%s\n%s\n+\n%s\n" % (name, CHARS[q].tobytes(),
                                            (ph + 33).astype(np.uint8)
                                            .tobytes()))
    return sum(1 for o in out if o[0].startswith(b"esc"))


def phase_cli_n(rng, work, device, base, idx, idx_bw, golden, genome,
                rep_starts, seg_len, n_reads_total, gpu):
    """bowtie's default command (-n 2 -l 28 -e 70 -k 1, verbose) and -n 2
    -a -m 3 -S through the CLI on the card, each counted from zero and
    traced; the records of the first V_SLICE reads must equal the CPU
    CLI's, and the library aligner's results on them the host oracle's.
    Then --sanity --stats on those reads, and -n 2 on the in-repo .ebwtl
    index against the CPU CLI (checks, off the main path)."""
    reads = os.path.join(work, "n_reads.fq")
    n_reads(rng, genome, rep_starts, seg_len, n_reads_total, reads)
    head = os.path.join(work, "n_head.fq")
    with open(reads, "rb") as f, open(head, "wb") as g:
        g.writelines(f.readlines()[:4 * V_SLICE])
    head_reads = list(ReadSource([head]).records())
    names = {r.name for r in head_reads}
    cpu = torch.device("cpu")
    runs, rows = {}, {}
    for tag, args, policy in (
            ("-n 2 (default)", [], KPolicy(khits=1)),
            ("-n 2 -a -m 3 -S", ["-n", "2", "-a", "-m", "3", "-S"],
             KPolicy(khits=INF, mhits=3))):
        out = os.path.join(work, "n%d.out" % len(args))
        dfs.FALLBACKS["lanes"] = 0
        ((wall, err), busy), launches = counted(lambda: profiled(
            lambda: run_cli(args + ["-x", base, reads, out], device)),
            device)
        fallbacks = dfs.FALLBACKS["lanes"]
        with open(out + ".err", "w") as f:      # for phase cli_dist
            f.write(err)
        require(all(launches[k] > 0 for k in (
            "derive_rows", "dfs_machine", "dfs_pack", "derive_b_jobs")),
            f"cli {tag} launched {launches}")
        t = time.time()
        run_cli(args + ["-x", base, head, out + ".cpu"], cpu)
        cpu_s = time.time() - t
        want = records_of(out + ".cpu", names)
        require(records_of(out, names) == want, f"cli {tag}: card and CPU "
                f"records of the first {V_SLICE} reads differ")
        lib = nd.DeviceNAligner(idx, idx_bw, policy, device=device)
        got = [result_key(r) for r in lib.align_batch(head_reads)]
        t = time.time()
        ora = OracleAligner(*golden, policy, mode="n", maxbts=N_MAXBTS)
        require(got == [result_key(r) for r in ora.align_batch(head_reads)],
                f"{tag}: the card's results on the first {V_SLICE} reads "
                "differ from the host oracle's")
        rows[tag] = {"wall_s": wall, "reads_per_s": n_reads_total / wall,
                     "device_busy_s": busy, "device_busy_share": busy / wall,
                     "launches": launches, "fallbacks": fallbacks,
                     "cpu_equal_lines": len(want), "cpu_slice_s": cpu_s,
                     "oracle_s": time.time() - t,
                     "summary": err.strip().splitlines()}
        runs["cli " + tag] = launches
    # --sanity --stats: every batch also through the host oracle; a
    # divergence raises (run_cli then fails)
    t = time.time()
    (_w, err), launches = counted(lambda: run_cli(
        ["--sanity", "--stats", "-x", base, head,
         os.path.join(work, "sanity.out")], device), device)
    require("AlignerMetrics:" in err, "--stats printed no metrics")
    rows["--sanity --stats (first slice)"] = {
        "wall_s": time.time() - t, "launches": launches,
        "stderr": err.strip().splitlines()}
    runs["check --sanity --stats"] = launches
    # the .ebwtl index on the card against the CPU
    g_fq = os.path.join(work, "gold.fq")
    n_esc = gold_reads(rng, g_fq)
    outs = []
    for dev in (device, cpu):
        o = os.path.join(work, f"ebwtl.{dev.type}")
        _w, err = run_cli(["-n", "2", "-x", GOLD_L, g_fq, o], dev)
        with open(o, "rb") as f:
            outs.append((f.read(), err))
    require(outs[0] == outs[1], ".ebwtl: card and CPU CLI output differ")
    require(len(outs[0][0]) > 0, ".ebwtl: no alignments")
    rows["-n 2 on small_index_l (.ebwtl)"] = {
        "escaped_ftab_reads": n_esc, "summary": outs[0][1].splitlines()}
    emit({"phase": "cli_n", "reads": n_reads_total, "gpu": gpu,
          "slice_reads": V_SLICE, "runs": rows})
    return runs


BEST_READS = 2048
THIN_BEST_READS = 128
BEST_STEPS = 2000              # the plain version's step budget, dense pair
THIN_BEST_STEPS = 2500         # and on the offRate-13 pair
BEST_HOST_LANES = 96           # lanes past the budget held to the host engine
# (name, aligner kwargs, policy (khits, mhits, -M), thinned pair)
BEST_POLICIES = (
    ("-v 2 -k 3 --best --strata", dict(v=2, strata=True), (3, INF, False),
     False),
    ("-v 3 -m 1 --best", dict(v=3), (1, 1, False), False),
    ("-n 2 -M 1 --best", dict(mode="n", seed_mms=2), (1, 1, True), False),
    ("-v 1 -k 1 --best, offRate 13", dict(v=1), (1, INF, False), True))


def k10_bytes(work, host, L, out, paired=False) -> int:
    """What the best-first machine must read and write: the distinct index
    items its plain version counted (as k7_bytes prices them), each lane's
    initial state (pack_init's row, a paired run's with its per-mate
    columns; its [ndt, 2L] by-depth rows, its seed) and every output as
    the kernel writes it (int32)."""
    B, ndt = host["rows_qp"].shape[:2]
    nd = host["act"].shape[1]
    init_w = sum(w for _k, w in bd.init_layout(nd, ndt, paired))
    return (16 * work["occ_entries"] + 32 * work["bwt_blocks"]
            + 4 * work["sa_entries"] + 8 * work["ftab_entries"]
            + B * (4 * init_w + ndt * 2 * L + 8)
            + 4 * sum(out[k].numel() for k in bd.OUT_KEYS) + 4 * B)


def k11_bytes(out) -> int:
    """What the packing must read and write: each lane's five scalars in
    (overflow as 1 byte) and out, and each counted hit row once in and
    once out."""
    B = out["nhits"].numel()
    return B * (4 * 4 + 1 + 5 * 4) + 2 * 4 * bd.HIT_W * int(out["nhits"].sum())


def best_decoded(al, reads, out, seeds):
    """The Hits of the lanes K10 finished without overflow, through the
    aligner's assemble (reads, out, seeds: the lanes' own)."""
    ok = (~out["overflow"]).nonzero()[:, 0].tolist()
    h = bd.unpack_harvest(bd.best_pack(out).cpu().numpy(), len(reads))
    res = al.assemble([reads[b] for b in ok],
                      {k: v[ok] for k, v in h.items()}, seeds[ok])
    return [hit for r in res for hit in r.hits]


def best_case(name, al, reads, max_steps, device, genome_chars, timed):
    """K10 and K11 on one batch, each held to its plain version on the
    card; K10 lane for lane wherever the plain version finished within
    max_steps, and on the lanes past that budget that K10 finished, to the
    host best-first engine (the budget rule, align/best_device.py)."""
    B = len(reads)
    L = dfs._len_bucket(max(len(r.seq) for r in reads))
    seeds = fill_seed_caches(reads, 0)
    seeds_d = torch.from_numpy(seeds.astype(np.int64)).to(device)
    host = al.hostinit.build(reads, L, seeds)
    kw = dict(L=L, nd=al.nd, ndt=al.ndt, maxbts=al.maxbts,
              n_k=al._sink_n(), m_max=min(al.policy.max, bd.INF32),
              strata=al.strata, qual_lim=al.qual_lim,
              qual_order=al.qual_order, bt_on=al.bt_on,
              has_seeded=al.mode == "n")
    out, transitions = bd.run_machine(al.pair, al.hostinit.cfg, host,
                                      seeds_d, max_steps=max_steps, **kw)
    cfg = {k: torch.from_numpy(v.astype(np.int64)).to(device)
           for k, v in al.hostinit.cfg.items()}
    pkw = {k: v for k, v in kw.items() if k != "maxbts"}
    pkw.update(nfrag=al.pair.nfrag, fc=al.pair.ftab_chars)

    def plain(work=None):
        st = bd.init_state(B, L, al.nd, al.ndt, seeds, host, al.maxbts,
                           device)
        return bd.run_machine_plain(al.pair, cfg, st, chunk=max_steps,
                                    work=work, **pkw)
    # timed, the one plain run also counts the work the bound prices
    work = {} if timed else None
    (st, iters), k10_plain_ms = time_once(lambda: plain(work), device)
    done = st["mode"] == bd.M_DONE
    ok = done & ~st["overflow"]
    require(bool((out["overflow"][done] == st["overflow"][done]).all()),
            f"{name}: K10 and its plain version flag different lanes")
    err10 = max_abs_err([(out[k][ok], st[k][ok]) for k in bd.OUT_KEYS])
    require(err10 == 0, f"{name}: K10 disagrees with its plain version on "
            "lanes the plain version finished")
    packed = bd.best_pack(out)
    err11 = max_abs_err([(packed, bd.best_pack_plain(out))])
    require(err11 == 0, f"{name}: K11 disagrees with its plain version")
    decoded = best_decoded(al, reads, out, seeds)
    check_mm_hits(decoded, genome_chars)
    past = (~done & (out["mode"] == bd.M_DONE) & ~out["overflow"])
    n_past = int(past.sum())
    # the host engine is Python and slow: hold the first BEST_HOST_LANES
    past = past.nonzero()[:BEST_HOST_LANES, 0].tolist()
    t = time.time()
    if past:
        h = bd.unpack_harvest(packed.cpu().numpy(), B)
        got = al.assemble([reads[b] for b in past],
                          {k: v[past] for k, v in h.items()}, seeds[past])
        host_al = al._host_aligner()
        for b, r in zip(past, got):
            require(result_key(r) == result_key(host_al.align_read(
                reads[b])), f"{name}: lane {b} ({reads[b].name!r}): K10's "
                "result differs from the host engine's")
    row = dict(reads=B, L=L, nd=al.nd, ndt=al.ndt, dense=al.pair.dense,
               off_rate=al.pair.fw.off_rate, max_steps=max_steps,
               plain_iterations=int(iters),
               kernel_max_transitions=int(transitions),
               budget_lanes=int((~done).sum()),
               kernel_budget_lanes=int((out["mode"] != bd.M_DONE).sum()),
               overflow_lanes=int(out["overflow"].sum()),
               kernel_past_budget_lanes=n_past,
               host_checked_lanes=len(past), host_s=time.time() - t,
               hits=len(decoded),
               hits_with_mismatches=sum(1 for h in decoded if h.mms),
               k10_plain_ms=k10_plain_ms, max_abs_err=max(err10, err11))
    if not timed:
        return row, None
    row["work"] = work
    nbytes10 = k10_bytes(work, host, L, out)
    nbytes11 = k11_bytes(out)

    def run10():
        return bd.run_machine(al.pair, al.hostinit.cfg, host, seeds_d,
                              max_steps=max_steps, **kw)
    slot = torch.arange(bd.H_MAX, device=device)
    hits3 = out["hits"].view(B, bd.H_MAX, bd.HIT_W)
    stats = {
        "K10": dict(
            name="K10 best_machine (K1/K5 rank4/lf4pair inlined)",
            route="cuda", source=BEST_SOURCE,
            replaces="bowtie_tpu/align/best_device.py:2224 (:638 init)",
            **machine_ms(run10, 10),
            call_ms=time_ms(run10, device, 5),
            plain_ms=k10_plain_ms, plain_with_work_count=True,
            **bounds(nbytes10, work["rank_codes"], work["walk_steps"],
                     work["word_codes"],
                     2 * work["rank_ends"] + 2 * work["walk_steps"]
                     + work["sa_loads"]),
            library_ms=None, library=NO_LIBRARY_K10, max_abs_err=err10,
            lanes=B, rank_ends=work["rank_ends"],
            sa_loads=work["sa_loads"], bytes=nbytes10, policy=name),
        "K11": dict(
            name="K11 best_pack", route="cuda", source=BEST_SOURCE,
            replaces="bowtie_tpu/align/best_device.py:2264, :2270, :2311",
            ms=time_ms(lambda: bd.best_pack(out), device, 20),
            plain_ms=time_once(lambda: bd.best_pack_plain(out), device)[1],
            **bounds(nbytes11, 0, 0, 0, -(-nbytes11 // SECTOR)),
            library_ms=time_ms(lambda: hits3[slot < out["nhits"][:, None]],
                               device, 20),
            library="hits[slot < nhits] (boolean index)",
            max_abs_err=err11, rows=int(out["nhits"].sum()),
            bytes=nbytes11, policy=name),
    }
    return row, stats


def phase_best(rng, work, device, genome, rep_starts, seg_len, idx, idx_bw):
    """K10 and K11 against their plain versions on the card under three
    policies on the dense pair and one on the pair thinned to offRate 13;
    the first timed."""
    genome_chars = CHARS[genome].tobytes()
    reads = n_reads(rng, genome, rep_starts, seg_len, BEST_READS,
                    os.path.join(work, "best.fq"))
    thin = (thinned_index(idx), thinned_index(idx_bw))
    cases, stats = {}, None
    for i, (name, akw, (k, m, sample), walk) in enumerate(BEST_POLICIES):
        t = time.time()
        policy = KPolicy(khits=k, mhits=m, sample_max=sample)
        al = bd.DeviceBestAligner(*(thin if walk else (idx, idx_bw)), policy,
                                  compact=walk, device=device, **akw)
        cases[name], st = best_case(
            name, al, reads[:THIN_BEST_READS] if walk else reads,
            THIN_BEST_STEPS if walk else BEST_STEPS, device, genome_chars,
            timed=i == 0)
        cases[name]["wall_s"] = time.time() - t
        stats = stats or st
    walk = cases[BEST_POLICIES[-1][0]]
    require(not walk["dense"] and walk["off_rate"] == 13,
            "the walk case ran on a dense pair")
    emit({"phase": "best", "cases": cases,
          "ms": {k: v["ms"] for k, v in stats.items()}})
    return stats


BEST_CLI_READS = 25_000
BEST_SLICE = 160


def check_verbose_mm(path, genome_chars):
    """Every verbose record's aligned read equals the reference at its
    offset except at its reported mismatches (offset:ref>read, offsets
    from the read's 5' end), where the reference holds the reported base.
    -> records checked."""
    n = 0
    with open(path, "rb") as f:
        for line in f:
            p = line.rstrip(b"\n").split(b"\t")
            minus, off, seq = p[1] == b"-", int(p[3]), p[4]
            ln = len(seq)
            ref = genome_chars[off:off + ln]
            mm = {}
            for d in (p[7].split(b",") if len(p) > 7 and p[7] else []):
                pos, change = d.split(b":")
                i = int(pos)
                mm[ln - 1 - i if minus else i] = change[:1]
            for i in range(ln):
                want = mm.get(i, seq[i:i + 1])
                require(ref[i:i + 1] == want and (
                    i not in mm or seq[i:i + 1] != want),
                    f"record {p[0]!r} at {off} does not match the reference "
                    "at its reported mismatches")
            n += 1
    return n


def check_sam_md(path, genome_chars):
    """Every aligned SAM record's SEQ, with the reference bases its MD:Z
    tag names put in, equals the reference at POS.  -> records checked."""
    n = 0
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            p = line.rstrip(b"\n").split(b"\t")
            if int(p[1]) & 4:
                continue
            seq, pos = bytearray(p[9]), int(p[3]) - 1
            md = next(t[5:] for t in p[11:] if t.startswith(b"MD:Z:"))
            i = 0
            for num, base in re.findall(rb"(\d+)([A-Z]?)", md):
                i += int(num)
                if base:
                    seq[i] = base[0]
                    i += 1
            require(bytes(seq) == genome_chars[pos:pos + len(seq)],
                    f"record {p[0]!r} at {pos} does not match the reference")
            n += 1
    return n


def phase_cli_best(rng, work, device, base, genome, rep_starts, seg_len,
                   gpu):
    """-v 2 -m 1 --best --strata -S and -n 2 --best -k 1 (verbose) through
    the CLI on the card, each counted from zero and traced, with its
    host-engine re-runs counted; every hit checked against the genome and
    the records of the first BEST_SLICE reads against the CPU CLI's."""
    genome_chars = CHARS[genome].tobytes()
    reads = os.path.join(work, "best_reads.fq")
    n_reads(rng, genome, rep_starts, seg_len, BEST_CLI_READS, reads)
    head = os.path.join(work, "best_head.fq")
    with open(reads, "rb") as f, open(head, "wb") as g:
        g.writelines(f.readlines()[:4 * BEST_SLICE])
    names = {r.name for r in ReadSource([head]).records()}
    runs, rows = {}, {}
    real_build = cli.build_aligner
    real_machine = bd.run_machine
    first = []

    def machine(*a, **k):         # the first run's first batch, kept
        if not first:
            first.append((a, k))
        return real_machine(*a, **k)
    for tag, args, sam in (
            ("-v 2 -m 1 --best --strata -S",
             ["-v", "2", "-m", "1", "--best", "--strata", "-S"], True),
            ("-n 2 --best -k 1", ["-n", "2", "--best", "-k", "1"], False)):
        out = os.path.join(work, "best%d.out" % len(args))
        built = []

        def build(*a, **k):
            built.append(real_build(*a, **k))
            return built[-1]
        cli.build_aligner = build
        bd.run_machine = machine
        try:
            ((wall, err), busy), launches = counted(lambda: profiled(
                lambda: run_cli(args + ["-x", base, reads, out], device)),
                device)
        finally:
            cli.build_aligner = real_build
            bd.run_machine = real_machine
        require(isinstance(built[0], bd.DeviceBestAligner),
                f"cli {tag} built {type(built[0]).__name__}")
        require(launches["best_machine"] > 0 and launches["best_pack"] > 0,
                f"cli {tag} launched {launches}")
        checked = (check_sam_md if sam else check_verbose_mm)(out,
                                                              genome_chars)
        require(checked > 0, f"cli {tag}: no alignments")
        t = time.time()
        run_cli(args + ["-x", base, head, out + ".cpu"], torch.device("cpu"))
        cpu_s = time.time() - t
        want = records_of(out + ".cpu", names)
        require(records_of(out, names) == want, f"cli {tag}: card and CPU "
                f"records of the first {BEST_SLICE} reads differ")
        rows[tag] = {"wall_s": wall, "reads_per_s": BEST_CLI_READS / wall,
                     "device_busy_s": busy, "device_busy_share": busy / wall,
                     "launches": launches, "fallbacks": built[0].fallbacks,
                     "records_checked": checked,
                     "cpu_equal_lines": len(want), "cpu_slice_s": cpu_s,
                     "summary": err.strip().splitlines()}
        runs["cli " + tag] = launches
    # K10 alone on the first run's first batch (the CLI's own call), no
    # plain run: its numbers beside the kernels line's 2,048 reads
    a, k = first[0]
    require(len(a[3]) == min(CLI_BATCH, BEST_CLI_READS),
            f"cli_best: K10's first batch took {len(a[3])} lanes")
    k10_batch = dict(machine_ms(lambda: bd.run_machine(*a, **k), 10),
                     lanes=len(a[3]), L=k["L"], nd=k["nd"], ndt=k["ndt"],
                     policy="-v 2 -m 1 --best --strata -S, the CLI's first "
                            "batch")
    emit({"phase": "cli_best", "reads": BEST_CLI_READS, "gpu": gpu,
          "slice_reads": BEST_SLICE, "runs": rows, "k10_batch": k10_batch})
    return runs, k10_batch


PE_LEN = 50
PE_PAIRS = 512                 # the pe phase: 2,048 lanes
THIN_PE_PAIRS = 128
PE_STEPS = 2000                # the plain version's step budget, dense pair
THIN_PE_STEPS = 2500           # and on the offRate-13 pair
# (name, aligner kwargs, policy (khits, mhits), rec_cap, thinned pair)
PE_POLICIES = (
    ("-n 2 -k 1 (rec_cap 1, after phase 0)", dict(mode="n", seed_mms=2),
     (1, INF), 1, False),
    ("-v 2 -a -m 3 (uncapped)", dict(mode="v", v=2), (INF, 3), None, False),
    ("-n 2 -k 1 (rec_cap 1, after phase 0), offRate 13",
     dict(mode="n", seed_mms=2), (1, INF), 1, True))
K12_STRANDS = 1 << 21          # K12 timed beside K2, on as many strands
CLI_PE_PAIRS = 12_000            # one whole CLI batch and a part
CLI_BATCH = 8192               # the CLI's --batch-size default
PE_HOST_SLICE = 400            # pairs held to the V1 host engine
PE_P_SLICE = 800                # pairs run with -p 4 and -p 1
NO_LIBRARY_K10R = ("n/a: no single PyTorch call records a best-first "
                   "search's ranges")
NO_LIBRARY_K13 = "n/a: no single PyTorch call runs the V1 interleave"
ILV_SOURCE = "bowtie_tpu_torch/csrc/ilv.cu"
SMALL_PE_PAIRS = 256           # K13 on the in-repo 5-fragment index
# a timed K13 case's numbers in the kernels line
K13_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "bytes_ms", "ops_ms",
            "sector_ms", "bytes", "int_ops", "max_abs_err", "pairs",
            "lanes", "max_iterations")


def pe_pairs(rng, genome, rep_starts, seg_len, n, path1, path2):
    """n pairs of PE_LEN-base mates in --fr orientation as two FASTQ files
    (names p<i>/1, p<i>/2): fragments of 100-250 bases (5 % of pairs
    400-600, past -X 250), from either strand, 10 % starting in a repeat
    copy; 10 % of pairs with one random mate (so rescue runs); each mate
    with the n phase's mix: 10 % one mismatch, 5 % an N, 5 % cut to 5-9
    bases, a second mismatch in every fourth mate, three in every third,
    qualities from Phred 2-40.  -> the pairs, read back."""
    L = PE_LEN
    frag = rng.integers(100, 251, n)
    far = rng.random(n) < 0.05
    frag[far] = rng.integers(400, 601, int(far.sum()))
    start = rng.integers(0, len(genome) - 601, n)
    rep = rng.random(n) < 0.10
    start[rep] = (rep_starts[rng.integers(0, len(rep_starts), rep.sum())]
                  + rng.integers(0, seg_len - 600, rep.sum()))
    left = genome[start[:, None] + np.arange(L)]
    right = genome[(start + frag - L)[:, None] + np.arange(L)]
    flip = rng.integers(0, 2, n) == 1       # the fragment's other strand
    m1 = np.where(flip[:, None], COMP[right[:, ::-1]], left)
    m2 = np.where(flip[:, None], left, COMP[right[:, ::-1]])
    codes = np.concatenate([m1, m2])         # mate 1s, then mate 2s
    rnd = np.flatnonzero(rng.random(n) < 0.10)
    rnd = rnd + n * rng.integers(0, 2, len(rnd))
    codes[rnd] = rng.integers(0, 4, (len(rnd), L))
    m = 2 * n
    rows = np.arange(m)
    u = rng.random(m)
    col = rng.integers(0, L, m)
    mm = u < 0.10
    codes[rows[mm], col[mm]] = (codes[rows[mm], col[mm]]
                                + rng.integers(1, 4, mm.sum())) % 4
    nk = (u >= 0.10) & (u < 0.15)
    codes[rows[nk], col[nk]] = 4
    lens = np.full(m, L, np.int32)
    sh = (u >= 0.15) & (u < 0.20)
    lens[sh] = rng.integers(5, 10, sh.sum())
    r4 = np.arange(0, m, 4)
    c4 = rng.integers(0, L, len(r4))
    c = codes[r4, c4]
    codes[r4, c4] = np.where(c < 4, (c + 1) % 4, c)
    r3 = np.arange(0, m, 3)
    c3 = np.argsort(rng.random((len(r3), L)), 1)[:, :3]
    c = codes[r3[:, None], c3]
    codes[r3[:, None], c3] = np.where(
        c < 4, (c + rng.integers(1, 4, c.shape)) % 4, c)
    quals = rng.integers(2, 41, (m, L)) + 33
    for path, half in ((path1, 0), (path2, 1)):
        with open(path, "wb") as f:
            for i in range(n):
                j = half * n + i
                ln = lens[j]
                f.write(b"@p%d/%d\n%s\n+\n%s\n" % (
                    i, half + 1, CHARS[codes[j, :ln]].tobytes(),
                    quals[j, :ln].astype(np.uint8).tobytes()))
    return list(PairedReadSource([path1], [path2]).pairs())


def head_pairs(path1, path2, n, tag, work):
    """The first n pairs of path1/path2 as two files of their own."""
    out = []
    for path, k in ((path1, 1), (path2, 2)):
        dst = os.path.join(work, f"{tag}_{k}.fq")
        with open(path, "rb") as f, open(dst, "wb") as g:
            g.writelines(f.readlines()[:4 * n])
        out.append(dst)
    return out


def pe_case(name, al, pairs, cap, max_steps, device, work=None):
    """K10r on the recorder's fused lanes of `pairs`, held to its plain
    version on the card on every lane the plain version finished within
    max_steps; the plain run counts into `work` when given.  -> (row, the
    run's inputs and outputs)."""
    a = al.record_inputs(pairs, cap)
    pair, cfg, host, seeds = a["args"]
    kw = dict(a["kw"], max_steps=max_steps, rec_cap=cap)
    out, transitions = bd.run_machine(pair, cfg, host, seeds, **kw)
    B = len(seeds)
    cfg_t = {k: torch.from_numpy(v.astype(np.int64)).to(device)
             for k, v in cfg.items()}
    pkw = {k: v for k, v in kw.items() if k not in ("maxbts", "max_steps")}
    pkw.update(nfrag=pair.nfrag, fc=pair.ftab_chars)
    seeds_h = seeds.cpu().numpy()

    def plain(work=None):
        st = bd.init_state(B, kw["L"], kw["nd"], kw["ndt"], seeds_h, host,
                           kw["maxbts"], device)
        return bd.run_machine_plain(pair, cfg_t, st, chunk=max_steps,
                                    work=work, **pkw)
    (st, iters), plain_ms = time_once(lambda: plain(work), device)
    done = st["mode"] == bd.M_DONE
    ok = done & ~st["overflow"]
    require(bool((out["overflow"][done] == st["overflow"][done]).all()),
            f"pe {name}: K10r and its plain version flag different lanes")
    err = max_abs_err([(out[k][ok], st[k][ok])
                       for k in ("hits", "nhits", "mode")])
    require(err == 0, f"pe {name}: K10r disagrees with its plain version "
            "on lanes the plain version finished")
    nh = out["nhits"].long()
    hits3 = out["hits"].view(B, bd.H_MAX, bd.HIT_W)
    last = hits3[torch.arange(B, device=device), (nh - 1).clamp(min=0), 6]
    row = dict(pairs=len(pairs), lanes=B, L=kw["L"], nd=kw["nd"],
               ndt=kw["ndt"], dense=pair.dense, off_rate=pair.fw.off_rate,
               rec_cap=cap, max_steps=max_steps,
               plain_iterations=int(iters),
               kernel_max_transitions=int(transitions),
               budget_lanes=int((~done).sum()),
               overflow_lanes=int(out["overflow"].sum()),
               ranges=int(nh.sum()), max_ranges=int(nh.max()),
               capped_lanes=int(((nh > 0) & (last == 2)).sum()),
               plain_ms=plain_ms, max_abs_err=err)
    require(row["ranges"] > 0, f"pe {name}: no range recorded")
    return row, (a, kw, out)


def k12_case(pair, mat, lens, efw, device):
    """K12 against its plain version on one matrix, timed there (the
    plain version's one run, the one it is held to) and alone.
    Bound: K2's model (bounds), with the LF steps and words the plain
    version counts; the index bytes are the smaller of both indexes read
    once and every sector the search touches (an ftab entry's two, each
    range end's occ and bwt sectors per LF step)."""
    top, bot = exact_ranges_cat(pair, mat, lens, efw)
    n = mat.shape[0]
    work = torch.zeros(2, n, dtype=torch.int64, device=device)
    (ptop, pbot), plain_ms = time_once(
        lambda: exact_ranges_cat_plain(pair, mat, lens, efw, work), device)
    err = max_abs_err([(top, ptop), (bot, pbot)])
    require(err == 0, f"K12 disagrees with its plain version by {err} on "
            f"{n} lanes")
    lf_steps, words = (int(x) for x in work.sum(1))
    n_ftab = int((lens >= pair.ftab_chars).sum())
    sectors = 2 * n_ftab + 2 * 2 * lf_steps
    index = min(sum(_nbytes(f.bwt, f.occ, f.ftab_hi, f.ftab_lo)
                    for f in (pair.fw, pair.bw)), SECTOR * sectors)
    return dict(
        ms=time_ms(lambda: exact_ranges_cat(pair, mat, lens, efw), device,
                   20),
        plain_ms=plain_ms,
        **bounds(index + _nbytes(mat, lens, efw) + 16 * n, 2 * lf_steps, 0,
                 words, sectors), index_bytes=index,
        max_abs_err=err, lanes=n, L=mat.shape[1],
        mirror_lanes=int((efw == 0).sum()),
        lanes_hit=int((bot > top).sum()), lf_steps_per_end=lf_steps)


def k12_strands(rng, genome, rep_starts, seg_len, device):
    """K12_STRANDS strands of the kernels phase's read mix (both strands
    of K12_STRANDS / 2 reads, right-aligned as K2 takes them), the odd
    lanes reversed for the mirror index.  -> (mat, lens, efw) on device."""
    codes, lens, *_ = make_reads(rng, genome, rep_starts, seg_len,
                                 K12_STRANDS // 2)
    mat, lens = strand_matrix(codes, lens)
    n, L = mat.shape
    efw = (np.arange(n) % 2 == 0).astype(np.uint8)
    col = np.arange(L)[None, :]
    ln = lens[:, None]
    src = np.where(col >= L - ln, 2 * L - 1 - ln - col, col)
    rev = np.take_along_axis(mat, src, 1)
    mat = np.where(efw[:, None] == 1, mat, rev).astype(np.uint8)
    return (torch.from_numpy(mat).to(device), torch.from_numpy(lens).to(device),
            torch.from_numpy(efw).to(device))


def small_pairs(rng, refs, n, path1, path2):
    """n --fr pairs of PE_LEN-base mates of the in-repo small genome
    (three records in five fragments): fragments of 100-250 bases from
    either strand, 0-2 mismatches a mate, every 10th pair with a random
    mate 1, every 20th with an N in mate 2.  -> the pairs, read back."""
    L = PE_LEN
    recs = [[], []]
    for k in range(n):
        r = np.minimum(refs[k % len(refs)], 4).astype(np.uint8)
        if k % 2:
            r = np.where(r < 4, 3 - r, 4)[::-1]
        frag = int(rng.integers(100, 251))
        p = int(rng.integers(0, len(r) - frag))
        m1 = r[p:p + L].copy()
        dn = r[p + frag - L:p + frag]
        m2 = np.where(dn < 4, 3 - dn, 4)[::-1].astype(np.uint8)
        if k % 10 == 3:
            m1 = rng.integers(0, 4, L).astype(np.uint8)
        for q in (m1, m2):
            for _ in range(k % 3):
                q[int(rng.integers(L))] = rng.integers(0, 4)
        if k % 20 == 7:
            m2[int(rng.integers(L))] = 4
        for j, q in enumerate((m1, m2)):
            recs[j].append(b"@s%d/%d\n%s\n+\n%s\n" % (
                k, j + 1, CHARS[q].tobytes(),
                (rng.integers(2, 41, L) + 33).astype(np.uint8).tobytes()))
    for path, rows in ((path1, recs[0]), (path2, recs[1])):
        with open(path, "wb") as f:
            f.writelines(rows)
    return list(PairedReadSource([path1], [path2]).pairs())


def k13_bounds(work, B: int, S) -> dict:
    """K13's bound from what its plain version counted in this run.
    Bytes, each value at the least width its range needs: of each stream
    record popped its top and bottom rows (4 bytes each), driver and done
    flag (1 each); the distinct SA entries (4, dense or sampled), occ
    checkpoints (16) and BWT blocks (32) the chases read; the reference
    bytes the zig-zag scans read; of each scanned query its bases up to
    the last one a scan compared and, when seeded, the distinct penalties
    of the mismatches compared (1 byte each); of every lane its seed (4),
    the seven [4] tables of its streams and queries (nrec, capped, qlen,
    alen, qn, sol, wok: counts, flags and lengths, 1 byte each), its
    insert limits (2 each: at most 2,048) and its outputs (res_tidx,
    res_toff, res_left 4 bytes each, res_ham and the iterations 2, the
    other eight 1); the fragment table (start, index, offset: 4 each).
    Operations: per LF step a rank and a walk step over the words it
    needs (bounds' model), per compared base two (compare, count).
    Sectors: a record, a resolved row and a query row one each, an LF
    step two, the scanned reference bytes in 32-byte sectors."""
    lane = 4 + 7 * 4 + 2 * 2 + (3 * 4 + 2 * 2 + 8)
    nbytes = (10 * work["pops"] + 4 * work["sa_entries"]
              + 16 * work["occ_entries"] + 32 * work["bwt_blocks"]
              + work["ref_bytes"] + work["query_bases"]
              + work["pen_entries"] + lane * B + 12 * S.nfrag)
    b = bounds(nbytes, work["lf_steps"], work["lf_steps"], work["words"],
               work["pops"] + work["rows"] + 2 * work["lf_steps"]
               + work["scans"] + -(-work["ref_bytes"] // SECTOR))
    cmp_ms = 1e3 * 2 * work["bases"] / INT32_OPS_PER_S
    if cmp_ms + b["ops_ms"] > b["bound_ms"]:
        b.update(bound_ms=cmp_ms + b["ops_ms"], bound_by="operations")
    b.update(ops_ms=cmp_ms + b["ops_ms"],
             int_ops=b["int_ops"] + 2 * work["bases"], bytes=nbytes)
    return b


def k13_case(name, al, pairs, device, timed):
    """K13 against its plain version on the card on round 1's streams of
    `pairs` (rec_cap 1 after phase 0, as align_batch records them): all
    12 outputs and each lane's iterations must be equal.  Timed: K13
    median of 20, the plain version the one run it is held to.  -> the
    case's row
    (with its bound from what the plain version counted)."""
    idxs = list(range(len(pairs)))
    s1 = fill_seed_caches([p[0] for p in pairs], al.global_seed)
    sts, ovd = al._record_all(al.plan(pairs), idxs, s1, 1)
    items = [(i, sts[i]) for i in idxs if not ovd[i]]
    S, st0, lanes, host = al.ilv_inputs(pairs, items, s1)
    require(lanes and not host, f"K13 {name}: {len(lanes)} lanes, "
            f"{len(host)} left to the host replay")

    def plain(work=None):
        return ilv.run_ilv_plain(al.pair, {k: v.clone()
                                           for k, v in st0.items()},
                                 S, work)
    kernels.reset_launches()
    out, iters = ilv.run_ilv(al.pair, st0, S)
    sync(device)
    require(kernels.LAUNCHES["pe_ilv"] == 1, "K13 did not launch once")
    (pout, piters), plain_ms = time_once(plain, device)
    err = max_abs_err([(out[k], pout[k]) for k in ilv.OUT_KEYS]
                      + [(iters, piters)])
    require(err == 0, f"K13 {name}: the kernel disagrees with its plain "
            f"version by {err}")
    o = {k: v.cpu() for k, v in out.items()}
    row = dict(pairs=len(pairs), lanes=len(lanes), Lq=S.Lq, SPAN=S.SPAN,
               dense=S.dense, off_rate=al.pair.fw.off_rate,
               nfrag=S.nfrag, max_steps=S.max_steps,
               decided=int((o["escalate"] == 0).sum()),
               found=int(o["res_found"].sum()),
               found_rc_phase=int((o["res_found"] * o["res_phase"]).sum()),
               escalated=int(o["escalate"].sum()),
               budget_lanes=int((o["mode"] != ilv.I_DONE).sum()),
               max_iterations=int(iters.max()), plain_ms=plain_ms,
               max_abs_err=err)
    require(row["found"] > 0, f"K13 {name}: no pair found")
    if timed:
        work = {}
        plain(work)
        row.update(
            ms=time_ms(lambda: ilv.run_ilv(al.pair, st0, S), device, 20),
            work=work, **k13_bounds(work, len(lanes), S))
    return row


def phase_pe(rng, rng_k12, work, device, genome, rep_starts, seg_len, idx,
             idx_bw, refs):
    """K12 against its plain version on phase 0's lanes and at
    K12_STRANDS strands, both timed; K10r against its plain version on the
    card under two policies on the dense pair and one on the pair thinned
    to offRate 13; the first (rec_cap 1, the lanes phase 0 leaves)
    timed."""
    pairs = pe_pairs(rng, genome, rep_starts, seg_len, PE_PAIRS,
                     os.path.join(work, "pe_1.fq"),
                     os.path.join(work, "pe_2.fq"))
    thin = (thinned_index(idx), thinned_index(idx_bw))
    cases, stats, k13_rows = {}, {}, {}
    for i, (name, akw, (k, m), cap, walk) in enumerate(PE_POLICIES):
        t = time.time()
        al = DevicePairedBestAligner(
            *(thin if walk else (idx, idx_bw)), refs,
            KPolicy(khits=k, mhits=m), compact=walk, device=device, **akw)
        require((al.rec_cap == cap), f"pe {name}: rec_cap {al.rec_cap}")
        # the timed policy's one plain run also counts the work the bound
        # prices
        work_c = {} if i == 0 else None
        row, (a, kw, out) = pe_case(
            name, al, pairs[:THIN_PE_PAIRS] if walk else pairs, cap,
            THIN_PE_STEPS if walk else PE_STEPS, device, work_c)
        row["wall_s"] = time.time() - t
        cases[name] = row
        if walk:
            k13_rows["offRate 13, 128 pairs"] = k13_case(
                "offRate 13", al, pairs[:THIN_PE_PAIRS], device, False)
        if i:
            continue
        k13 = k13_case(name, al, pairs, device, True)
        k13_rows[f"{PE_PAIRS} pairs, dense"] = k13
        stats["K13"] = dict(
            name="K13 pe_ilv (K1 lf_row inlined)", route="cuda",
            source=ILV_SOURCE,
            replaces="bowtie_tpu/align/pe_ilv_device.py:527 run_ilv_chunk "
                     "(:503 _machine_step: :151 _step_ilv, :262 "
                     "_step_chase, :400 _step_scan), :542 run_ilv",
            **{k: k13[k] for k in K13_KEYS},
            library_ms=None, library=NO_LIBRARY_K13, policy=name)
        main = k12_case(al.pair, *al.exact_inputs(
            al.plan(pairs), list(range(len(pairs)))), device)
        big = k12_case(al.pair, *k12_strands(
            rng_k12, genome, rep_starts, seg_len, device), device)
        row["phase0_lanes"] = main["lanes"]
        require(row["lanes"] < main["lanes"],
                f"pe {name}: phase 0 settled no lane")
        stats["K12"] = dict(
            name="K12 exact_ranges_cat (K1 inlined)", route="cuda",
            source=SOURCE, replaces="bowtie_tpu/align/pe_device.py:37",
            **main, library_ms=None, library=NO_LIBRARY, match=True,
            at_strands=big)
        row["work"] = work_c
        nbytes = k10_bytes(work_c, a["args"][2], kw["L"], out)
        stats["K10r"] = dict(
            name="K10r best_machine, record mode (K1/K5 inlined)",
            route="cuda", source=BEST_SOURCE,
            replaces="bowtie_tpu/align/best_device.py:1030 (_step_main "
                     "record=True), :1064 _record_range, :854-866 "
                     "_cfgF/_cfgO",
            **machine_ms(lambda: bd.run_machine(*a["args"], **kw), 10),
            call_ms=time_ms(lambda: bd.run_machine(*a["args"], **kw),
                            device, 5),
            plain_ms=row["plain_ms"], plain_with_work_count=True,
            **bounds(nbytes, work_c["rank_codes"], work_c["walk_steps"],
                     work_c["word_codes"],
                     2 * work_c["rank_ends"] + 2 * work_c["walk_steps"]
                     + work_c["sa_loads"]),
            library_ms=None, library=NO_LIBRARY_K10R, max_abs_err=0,
            lanes=row["lanes"], rank_ends=work_c["rank_ends"],
            bytes=nbytes, policy=name)
    require(cases[PE_POLICIES[0][0]]["capped_lanes"] > 0,
            "pe: no lane reached rec_cap 1")
    walk = cases[PE_POLICIES[-1][0]]
    require(not walk["dense"] and walk["off_rate"] == 13,
            "the walk case ran on a dense pair")
    # K13 on the in-repo index of five fragments (the 4.6 Mbp genome is
    # one record, which never reaches joinedToTextOff's fragment search)
    gidx, gidx_bw = read_ebwt(GOLD), read_ebwt(GOLD + ".rev")
    grefs = unpack_reference(*read_bitpair_reference(GOLD),
                             plen=gidx.plen)
    al = DevicePairedBestAligner(gidx, gidx_bw, grefs, KPolicy(),
                                 device=device)
    gpairs = small_pairs(rng_k12, grefs, SMALL_PE_PAIRS,
                         os.path.join(work, "small_pe_1.fq"),
                         os.path.join(work, "small_pe_2.fq"))
    k13_rows["small_index, 5 fragments"] = k13_case(
        "small_index", al, gpairs, device, False)
    require(k13_rows["small_index, 5 fragments"]["nfrag"] == 5,
            "small_index is not the five-fragment index")
    require(k13_rows["offRate 13, 128 pairs"]["dense"] is False,
            "K13's walk case ran on a dense pair")
    emit({"phase": "pe", "cases": cases, "k13": k13_rows,
          "ms": {k: v["ms"] for k, v in stats.items()}})
    return stats


PEV2_SMALL_PAIRS = 256         # the -n 3 and walk-left cases
PEV2_STEPS = 2000              # the plain version's step budget, timed
# case (cli_pe's first --best batch); BUDGET_STEPS in phase pev2's two
# (the budget cases), whose lanes
# past it are all held to the V2 host engine: a plain iteration of K14
# costs about the same whatever the lane count, so the budget, not the
# pairs, sets the phase's time
BUDGET_STEPS = 300
NO_LIBRARY_K14 = ("n/a: no single PyTorch call records a best-first "
                  "search's merged stream")
# (name, aligner kwargs, rec_cap, thinned pair, pairs, plain budget)
PEV2_POLICIES = (
    ("-n 3 --best (16/48, uncapped), plain budget 300",
     dict(mode="n", seed_mms=3), None, False, PEV2_SMALL_PAIRS,
     BUDGET_STEPS),
    ("-n 2 --best (rec_cap 8), offRate 13, plain budget 300",
     dict(mode="n", seed_mms=2), 8, True, PEV2_SMALL_PAIRS, BUDGET_STEPS))


def v2_key(r):
    """A paired result's fields, each hit's mate fields included."""
    return ([(h.fw, h.tidx, h.toff, h.oms, h.stratum, h.cost, tuple(h.mms),
              h.mate, h.mfw, h.mtidx, h.mtoff, h.mlen) for h in r.hits],
            r.maxed, r.nvalid, r.sampled, r.nbuffered)


def pev2_case(name, al, pairs, cap, max_steps, device, timed):
    """K14 on the merged lanes of `pairs` (one per pair), held to its plain
    version on the card on every lane the plain version finished within
    max_steps, and K11 on its records; every lane past that budget that
    K14 finished, replayed, to the V2 host engine.  Timed: K14's launch
    alone median of 10, the wrapper's call median of 5; the plain run
    counts the work its bound prices, and its time includes the count
    (the plain version is run once: its iterations are slow).  -> (row,
    the kernels-line entry when timed)."""
    s1 = fill_seed_caches([p[0] for p in pairs], al.global_seed)
    s2 = fill_seed_caches([p[1] for p in pairs], al.global_seed)
    a = al.machine.record_inputs(pairs, s1, s2)
    pair, cfg, host, seeds = a["args"]
    kw = dict(a["kw"], max_steps=max_steps, rec_cap=cap)
    kernels.reset_launches()
    out, transitions = bd.run_machine(pair, cfg, host, seeds, **kw)
    sync(device)
    require(kernels.LAUNCHES["best_pev2"] == 1
            and kernels.LAUNCHES["best_record"] == 0,
            f"pev2 {name}: launched {kernels.LAUNCHES}")
    B = len(seeds)
    cfg_t = {k: torch.from_numpy(np.asarray(v).astype(np.int64)).to(device)
             for k, v in cfg.items()}
    pkw = {k: v for k, v in kw.items() if k not in ("maxbts", "max_steps")}
    pkw.update(nfrag=pair.nfrag, fc=pair.ftab_chars)
    seeds_h = seeds.cpu().numpy()

    def plain(work=None):
        st = bd.init_state(B, kw["L"], kw["nd"], kw["ndt"], seeds_h, host,
                           kw["maxbts"], device)
        return bd.run_machine_plain(pair, cfg_t, st, chunk=max_steps,
                                    work=work, **pkw)
    work_c = {} if timed else None
    (st, iters), plain_ms = time_once(lambda: plain(work_c), device)
    done = st["mode"] == bd.M_DONE
    ok = done & ~st["overflow"]
    require(bool((out["overflow"][done] == st["overflow"][done]).all()),
            f"pev2 {name}: K14 and its plain version flag different lanes")
    err = max_abs_err([(out[k][ok], st[k][ok])
                       for k in ("hits", "nhits", "mode", "result", "count")])
    require(err == 0, f"pev2 {name}: K14 disagrees with its plain version "
            "on lanes the plain version finished")
    packed = bd.best_pack(out)
    err11 = max_abs_err([(packed, bd.best_pack_plain(out))])
    require(err11 == 0, f"pev2 {name}: K11 disagrees with its plain version")
    h = bd.unpack_harvest(packed.cpu().numpy(), B)
    past = (~done & (out["mode"] == bd.M_DONE) & ~out["overflow"])
    n_past = int(past.sum())
    past = past.nonzero()[:, 0].tolist()
    t = time.time()
    take = a["take"]
    replayed = 0
    for j in past:
        i = int(take[j])
        res = al.replayer.replay(*pairs[i],
                                 h["hits"][j, :int(h["nhits"][j])],
                                 capped=cap is not None)
        if res is None:
            continue               # outran its cap: the aligner re-records
        replayed += 1
        require(v2_key(res) == v2_key(al.align_pair_host(*pairs[i])),
                f"pev2 {name}: pair {i} ({pairs[i][0].name!r}): K14's "
                "stream replays to another result than the V2 host "
                "engine's")
    nh = h["nhits"].astype(np.int64)
    last = h["hits"][np.arange(B), np.maximum(nh - 1, 0), 6]
    # the ranges of mate 2's drivers (each record's column 0: its outer)
    recorded = np.arange(bd.H_MAX)[None, :] < nh[:, None]
    mate2 = int((recorded & ~al.machine.out_m1[h["hits"][:, :, 0]]).sum())
    row = dict(pairs=len(pairs), lanes=B, L=kw["L"], nd=kw["nd"],
               ndt=kw["ndt"], dense=pair.dense, off_rate=pair.fw.off_rate,
               rec_cap=cap, max_steps=max_steps,
               plain_iterations=int(iters),
               kernel_max_transitions=int(transitions),
               budget_lanes=int((~done).sum()),
               kernel_budget_lanes=int((out["mode"] != bd.M_DONE).sum()),
               overflow_lanes=int(out["overflow"].sum()),
               ranges=int(nh.sum()), max_ranges=int(nh.max()),
               mate2_ranges=mate2,
               capped_lanes=int(((nh > 0) & (last == 2)).sum()),
               kernel_past_budget_lanes=n_past,
               host_checked_pairs=replayed, host_s=time.time() - t,
               plain_ms=plain_ms, max_abs_err=max(err, err11))
    require(row["ranges"] > 0 and mate2 > 0,
            f"pev2 {name}: {row['ranges']} ranges, {mate2} of mate 2")
    if not timed:
        return row, None
    row["work"] = work_c
    nbytes = k10_bytes(work_c, host, kw["L"], out, paired=True)
    stats = dict(
        name="K14 best_machine, paired record mode (K1/K5 inlined)",
        route="cuda", source=BEST_SOURCE,
        replaces="bowtie_tpu/align/pev2_device.py:54 PairedV2Machine "
                 "(:157 record -> best_device.py:2224 run_chunk with "
                 "record=True, paired=True: :1141-1159, :1666-1673, "
                 ":675-681, :731, :1102, :1845, :1856, :2099)",
        **machine_ms(lambda: bd.run_machine(pair, cfg, host, seeds, **kw),
                     10),
        call_ms=time_ms(lambda: bd.run_machine(pair, cfg, host, seeds, **kw),
                        device, 5),
        plain_ms=plain_ms, plain_with_work_count=True,
        **bounds(nbytes, work_c["rank_codes"], work_c["walk_steps"],
                 work_c["word_codes"],
                 2 * work_c["rank_ends"] + 2 * work_c["walk_steps"]
                 + work_c["sa_loads"]),
        library_ms=None, library=NO_LIBRARY_K14, max_abs_err=row[
            "max_abs_err"], lanes=B, rank_ends=work_c["rank_ends"],
        plain_iterations=row["plain_iterations"],
        budget_lanes=row["budget_lanes"], bytes=nbytes, policy=name)
    return row, stats


def phase_pev2(rng, work, device, genome, rep_starts, seg_len, idx, idx_bw,
               refs):
    """K14 against its plain version on the card, the budget case: -n 3
    --best and -n 2 --best on the offRate-13 pair on PEV2_SMALL_PAIRS of
    the 4.6 Mbp index.  The plain version stops at BUDGET_STEPS
    iterations, and every lane past it that K14 finished is held,
    replayed, to the V2 host engine.  K14 under -n 2 --best on whole
    lanes, timed, is cli_pe's case on the CLI's first batch."""
    pairs = pe_pairs(rng, genome, rep_starts, seg_len, PEV2_SMALL_PAIRS,
                     os.path.join(work, "pev2_1.fq"),
                     os.path.join(work, "pev2_2.fq"))
    thin = (thinned_index(idx), thinned_index(idx_bw))
    cases = {}
    for name, akw, cap, walk, n, steps in PEV2_POLICIES:
        t = time.time()
        al = DevicePairedV2Aligner(
            *(thin if walk else (idx, idx_bw)), refs, KPolicy(),
            compact=walk, device=device, better=True, **akw)
        require(al.rec_cap == 8, f"pev2 {name}: rec_cap {al.rec_cap}")
        cases[name], _ = pev2_case(name, al, pairs[:n], cap, steps, device,
                                   timed=False)
        cases[name]["wall_s"] = time.time() - t
    walk = cases[PEV2_POLICIES[1][0]]
    require(not walk["dense"] and walk["off_rate"] == 13,
            "the walk case ran on a dense pair")
    require(cases[PEV2_POLICIES[0][0]]["nd"] == 16
            and cases[PEV2_POLICIES[0][0]]["ndt"] == 48,
            "the -n 3 case is not the 16/48 DAG")
    require(sum(c["host_checked_pairs"] for c in cases.values()) > 0,
            "pev2: no lane past the plain budget was held to the host")
    emit({"phase": "pev2", "cases": cases,
          "local_bytes": bd.machine_local_bytes()})


PEV2_TAG = "-1/-2 --best (-n 2 -k 1 --fr -X 250: the V2 engine, K14)"


def cli_pev2_run(work, device, base, m1, m2, genome_chars):
    """--best on the CLI_PE_PAIRS pairs through the CLI, counted from
    zero and traced: the recorded V2 engine must be
    built, K14 and K11 launched, and every reported mate must equal its
    reference substring but at its mismatches.  Then K14 on the CLI's
    first batch (CLI_BATCH pairs), with the aligner the CLI built, held to
    its plain version and timed as pev2_case does.  -> (row, launches,
    the batch case's kernels-line entry)."""
    out = os.path.join(work, "cli_pev2.out")
    argv = ["--best", "-x", base, "-1", m1, "-2", m2, out]
    built = []
    real_build = cli.build_aligner

    def build(*a, **k):
        built.append(real_build(*a, **k))
        return built[-1]
    cli.build_aligner = build
    try:
        ((wall, err), busy), launches = counted(lambda: profiled(
            lambda: run_cli(argv, device)), device)
    finally:
        cli.build_aligner = real_build
    al = built[-1]
    require(isinstance(al, DevicePairedV2Aligner),
            f"cli --best built {type(al).__name__}")
    require(launches["best_pev2"] > 0 and launches["best_pack"] > 0
            and launches["best_record"] == launches["best_machine"] == 0,
            f"cli --best launched {launches}")
    checked = check_verbose_mm(out, genome_chars)
    require(checked > 0, "cli --best: no alignments")
    batch = list(itertools.islice(PairedReadSource([m1], [m2]).pairs(),
                                  CLI_BATCH))
    batch_row, batch_stats = pev2_case(
        "-1/-2 --best, the CLI's first batch", al, batch, al.rec_cap,
        PEV2_STEPS, device, timed=True)
    require(batch_row["lanes"] == CLI_BATCH,
            f"cli --best: K14 took {batch_row['lanes']} of the batch's "
            f"{CLI_BATCH} pairs")
    require(batch_row["capped_lanes"] > 0,
            f"cli --best: no lane of the first batch reached rec_cap "
            f"{al.rec_cap}")
    return {"pairs": CLI_PE_PAIRS, "wall_s": wall,
            "pairs_per_s": CLI_PE_PAIRS / wall, "device_busy_s": busy,
            "device_busy_share": busy / wall, "launches": launches,
            "k14_launches": launches["best_pev2"],
            "fallbacks": al.fallbacks, "escalations": al.escalations,
            "rec_cap": al.rec_cap, "mates_checked": checked,
            "summary": err.strip().splitlines(),
            "k14_batch": batch_row}, launches, batch_stats


def phase_cli_pe(rng, work, device, base, genome, rep_starts, seg_len, gpu):
    """The default paired command (rec_cap 1 after phase 0) and -v 2 -a -m
    1 -S through the CLI on the card, each counted from zero and traced
    (the default command after a warm-up run), with the lanes K10r ran
    and those that overflowed, by mate length, per round; every reported
    mate checked against the genome; the default command on a slice held
    to the V1 host engine, and -p 4 to -p 1; K13 held to its plain
    version, and timed, on the first batch; --best likewise
    (cli_pev2_run), with K14 on its first batch, held to the V2 host
    engine on a slice and -p 4 to -p 1 and to the V2 host engine's -p 4.
    -> (launches by run, the K13 batch row, the K14 batch entry)."""
    genome_chars = CHARS[genome].tobytes()
    m1 = os.path.join(work, "cli_pe_1.fq")
    m2 = os.path.join(work, "cli_pe_2.fq")
    pe_pairs(rng, genome, rep_starts, seg_len, CLI_PE_PAIRS, m1, m2)
    runs, rows = {}, {}
    real_build = cli.build_aligner
    real_machine = pe.run_machine
    for tag, args, sam, cap in (
            ("-1/-2 (default: -n 2 -k 1 --fr -X 250)", [], False, 1),
            ("-1/-2 -v 2 -a -m 1 -S", ["-v", "2", "-a", "-m", "1", "-S"],
             True, None)):
        out = os.path.join(work, "cli_pe%d.out" % len(args))
        argv = args + ["-x", base, "-1", m1, "-2", m2, out]
        built, k10r = [], []

        def build(*a, **k):
            built.append(real_build(*a, **k))
            return built[-1]

        def machine(*a, **k):      # the recorder's K10r launches, kept
            res = real_machine(*a, **k)
            k10r[-1].append((k["rec_cap"], a[2]["qlen"], res[0]["overflow"]))
            return res
        cli.build_aligner = build
        pe.run_machine = machine
        try:
            # a warm-up run of the default command only: the other modes'
            # first runs take as long as their second
            k10r.append([])
            first_s = run_cli(argv, device)[0] if not args else None
            k10r.append([])
            ((wall, err), busy), launches = counted(lambda: profiled(
                lambda: run_cli(argv, device)), device)
        finally:
            cli.build_aligner = real_build
            pe.run_machine = real_machine
        al = built[-1]
        require(isinstance(al, DevicePairedBestAligner),
                f"cli {tag} built {type(al).__name__}")
        require(al.rec_cap == cap, f"cli {tag}: rec_cap {al.rec_cap}")
        require(launches["best_record"] > 0 and launches["best_pack"] > 0,
                f"cli {tag} launched {launches}")
        require((launches["exact_ranges_cat"] > 0) == (cap == 1)
                and (al.synthesized > 0) == (cap == 1),
                f"cli {tag}: phase 0 settled {al.synthesized} lanes in "
                f"{launches['exact_ranges_cat']} K12 launches")
        # K13 takes the -k 1 policy only, and decides most of its pairs
        r1 = al.ilv_by_round["round 1"]
        require(al.use_ilv == (cap == 1)
                and (launches["pe_ilv"] > 0) == (cap == 1)
                and (r1["decided"] > CLI_PE_PAIRS // 2) == (cap == 1),
                f"cli {tag}: {launches['pe_ilv']} K13 launches, "
                f"{al.ilv_by_round}")
        checked = (check_sam_md if sam else check_verbose_mm)(out,
                                                              genome_chars)
        require(checked > 0, f"cli {tag}: no alignments")
        by_cap = {}
        for c, qlen, ovf in k10r[-1]:
            r = by_cap.setdefault(f"rec_cap {c}", {"lanes": 0,
                                                   "overflow_by_len": {}})
            r["lanes"] += len(qlen)
            lens, counts = np.unique(qlen[ovf.cpu().numpy() != 0],
                                     return_counts=True)
            for ln, ct in zip(lens.tolist(), counts.tolist()):
                r["overflow_by_len"][ln] = r["overflow_by_len"].get(ln, 0) + ct
        rows[tag] = {"wall_s": wall, "first_run_s": first_s,
                     "pairs_per_s": CLI_PE_PAIRS / wall,
                     "device_busy_s": busy, "device_busy_share": busy / wall,
                     "launches": launches, "fallbacks": al.fallbacks,
                     "escalations": al.escalations, "rec_cap": al.rec_cap,
                     "k12_launches": launches["exact_ranges_cat"],
                     "lanes": 4 * CLI_PE_PAIRS,
                     "synthesized": al.synthesized,
                     "synthesized_share": al.synthesized / (4 * CLI_PE_PAIRS),
                     "k10r_lanes": sum(r["lanes"] for r in by_cap.values()),
                     "k10r_by_round": by_cap,
                     "k13_launches": launches["pe_ilv"],
                     "k13_by_round": al.ilv_by_round,
                     "k13_decided": al.ilv_decided,
                     "mates_checked": checked,
                     "summary": err.strip().splitlines()}
        runs["cli " + tag] = launches
        if cap == 1:
            # K13 on the streams of the CLI's first batch, as round 1
            # gives them to it, with the aligner the CLI built
            batch = list(itertools.islice(
                PairedReadSource([m1], [m2]).pairs(), CLI_BATCH))
            k13_batch = k13_case("cli batch", al, batch, device, True)
    # --best: the V2 engine over merged streams K14 records
    rows[PEV2_TAG], runs["cli " + PEV2_TAG], k14_batch = cli_pev2_run(
        work, device, base, m1, m2, genome_chars)
    # the default command on a slice: the card's bytes are the V1 host
    # engine's
    h1, h2 = head_pairs(m1, m2, PE_HOST_SLICE, "pe_host", work)
    outs = {}
    for name, host in (("card", False), ("host", True)):
        out = os.path.join(work, f"pe_slice.{name}")
        cli.build_aligner = (lambda *a, _h=host, **k: real_build(
            *a, **{**k, "host_engine": k.get("host_engine", False) or _h}))
        try:
            t = time.time()
            err = run_cli(["-x", base, "-1", h1, "-2", h2, out], device)[1]
            outs[name] = (open(out, "rb").read(), err.strip().splitlines(),
                          time.time() - t)
        finally:
            cli.build_aligner = real_build
    require(outs["card"][:2] == outs["host"][:2], "cli_pe: the card's "
            f"records of the first {PE_HOST_SLICE} pairs differ from the V1 "
            "host engine's")
    # --best on the same slice: the card's bytes are the V2 host engine's
    for name, host in (("card", False), ("host", True)):
        out = os.path.join(work, f"pev2_slice.{name}")
        cli.build_aligner = (lambda *a, _h=host, **k: real_build(
            *a, **{**k, "host_engine": k.get("host_engine", False) or _h}))
        try:
            t = time.time()
            err = run_cli(["--best", "-x", base, "-1", h1, "-2", h2, out],
                          device)[1]
            outs["best " + name] = (open(out, "rb").read(),
                                    err.strip().splitlines(),
                                    time.time() - t)
        finally:
            cli.build_aligner = real_build
    require(outs["best card"][:2] == outs["best host"][:2]
            and outs["best host"][0], "cli_pe: the card's --best records "
            f"of the first {PE_HOST_SLICE} pairs differ from the V2 host "
            "engine's")
    # -p 4 against -p 1 on the card
    p1, p2 = head_pairs(m1, m2, PE_P_SLICE, "pe_p", work)
    pouts = {}
    for p in ("1", "4"):
        out = os.path.join(work, f"pe_p{p}.out")
        t = time.time()
        err = run_cli(["-p", p, "-x", base, "-1", p1, "-2", p2, out],
                      device)[1]
        pouts[p] = (open(out, "rb").read(), err.strip().splitlines(),
                    time.time() - t)
    require(pouts["4"][:2] == pouts["1"][:2],
            "cli_pe: -p 4 writes other records than -p 1")
    # --best with -p 4 against -p 1 on the card (the replay's fork pool),
    # and against -p 4 on the V2 host engine (ParallelHostAligner)
    for name, p, host in (("best 1", "1", False), ("best 4", "4", False),
                          ("best host 4", "4", True)):
        out = os.path.join(work, f"pev2_p.{name.replace(' ', '_')}")
        cli.build_aligner = (lambda *a, _h=host, **k: real_build(
            *a, **{**k, "host_engine": k.get("host_engine", False) or _h}))
        try:
            t = time.time()
            err = run_cli(["--best", "-p", p, "-x", base, "-1", p1, "-2",
                           p2, out], device)[1]
            pouts[name] = (open(out, "rb").read(),
                           err.strip().splitlines(), time.time() - t)
        finally:
            cli.build_aligner = real_build
    require(pouts["best 4"][:2] == pouts["best 1"][:2]
            == pouts["best host 4"][:2] and pouts["best 1"][0],
            "cli_pe: --best -p 4 writes other records than -p 1, or the "
            "card's than the V2 host engine's")
    emit({"phase": "cli_pe", "pairs": CLI_PE_PAIRS, "gpu": gpu,
          "runs": rows, "k13_batch": k13_batch,
          "host_slice_pairs": PE_HOST_SLICE,
          "host_slice_bytes": len(outs["host"][0]),
          "best_host_slice_bytes": len(outs["best host"][0]),
          "best_host_slice_pairs_per_s": {
              k[5:]: PE_HOST_SLICE / v[2] for k, v in outs.items()
              if k.startswith("best ")},
          "host_slice_s": {k: v[2] for k, v in outs.items()},
          "p_slice_pairs": PE_P_SLICE,
          "p_slice_s": {k: v[2] for k, v in pouts.items()}})
    return runs, k13_batch, k14_batch


MESH_ENTRIES = 4               # K15's mesh: four shards on the one card
DFS_MESH_ENTRIES = 2


def phase_mesh(work, device, idx, idx_bw, fm, strands, devices=None):
    """K15 over a mesh of `devices` (default MESH_ENTRIES entries, all
    the one card: each shard one launch on its stream, one copy of the
    index), with the K3 remainder on each shard's top rows, and the DFS
    machine over DFS_MESH_ENTRIES entries of the one card (over `devices`
    when given) on phase dfs's -v 2 -a -m 3 lanes, all counted from zero;
    then
    held to one align_step and one run_machine on `device` over all
    strands and lanes."""
    mat_np, lens_np = strands
    mesh = make_mesh(devices or [device] * MESH_ENTRIES)
    mesh2 = make_mesh(devices or [device] * DFS_MESH_ENTRIES)
    reps = replicate_index(fm, mesh)
    require(len(reps) == len(set(mesh)), "one index copy per device")
    shards, B = shard_reads(mesh, mat_np, lens_np)
    reads = list(ReadSource([os.path.join(work, "dfs.fq")]).records())
    jobs, _J = build_v_jobs_vec(reads, 2, False, False, DFS_L)
    seeds = fill_seed_caches(reads, 0)
    c0 = np.zeros(len(reads), np.int32)
    pair = dfs.build_fmpair(idx, idx_bw, device, dense_sa=True)
    kw = dict(n_k=dfs.INF32, m_max=3, max_steps=20000)

    per = shards[0][0].shape[0]

    def drive():
        out = sharded_align_step(reps, shards)
        rem = [bwt_rows_offsets(reps[d], t.to(d), (b > t).to(d))
               for d, t, b in zip(mesh, out[0].split(per),
                                  out[1].split(per))]
        return out, rem, dfs_mesh.run_sharded(pair, jobs, seeds, c0, mesh2,
                                              **kw)

    t = time.time()
    (sh, rem, (dout, dit)), launches = counted(drive, device)
    wall = time.time() - t
    require(launches["align_step"] == len(mesh)
            and launches["bwt_rows_offsets"] == len(mesh)
            and launches["dfs_machine"] == len(mesh2)
            and launches["derive_rows"] == len(mesh2),
            f"phase mesh launched {launches}")
    mat = torch.from_numpy(mat_np).to(device)
    lens2 = torch.from_numpy(lens_np).to(device)
    one = align_step(fm, mat, lens2)
    err = max_abs_err([(a[:B], b) for a, b in zip(sh, one)])
    require(err == 0, f"K15 over {len(mesh)} shards differs from one "
            f"launch by {err}")
    has = one[1] > one[0]
    roff = torch.cat([r[0].to(device) for r in rem])[:B]
    rok = torch.cat([r[1].to(device) for r in rem])[:B]
    err_r = max_abs_err([(roff[has], one[2][has]), (rok, one[3])])
    require(err_r == 0, f"K3 remainder on the shards differs by {err_r}")
    jd = dfs.upload_jobs(jobs, pair.ftab_chars, device)
    single, sit = dfs.run_machine(
        pair, jd, torch.from_numpy(seeds.astype(np.int64)).to(device),
        torch.from_numpy(c0).to(device), **kw)
    bad = [k for k in dfs.OUT_KEYS if not torch.equal(dout[k], single[k])]
    require(not bad, f"run_sharded over {len(mesh2)} shards differs "
            f"from one run_machine in {bad}")
    require(dit == int(sit), f"run_sharded took {dit} transitions, one "
            f"run_machine {int(sit)}")
    emit({"phase": "mesh", "mesh": [str(d) for d in mesh],
          "strands": B, "strands_per_shard": per,
          "index_copies": len(reps), "dfs_mesh": [str(d) for d in mesh2],
          "dfs_lanes": len(reads), "dfs_max_transitions": dit,
          "dfs_nhits": int(dout["nhits"].sum()),
          "launches": {k: v for k, v in launches.items() if v},
          "wall_s": wall,
          # CUDA events on one card; across cards the host clock around
          # 20 calls, every card synchronised (events time one card only)
          "k15_sharded_ms": (
              time_ms(lambda: sharded_align_step(reps, shards), device, 20)
              if len(reps) == 1 else time_all_ms(
                  lambda: sharded_align_step(reps, shards), 20)),
          "k15_one_launch_ms": time_ms(lambda: align_step(fm, mat, lens2),
                                       device, 20),
          "checks": {"k15_shards_equal_one_launch": True,
                     "k3_remainder_equal_k15": True,
                     "run_sharded_equal_run_machine": True}})
    return launches


DIST_RANKS = 2
DIST_SKIP, DIST_UPTO = 1000, 30000


def launch_ranks(cmd, ranks):
    """`cmd` through `python -m bowtie_tpu_torch.parallel.launch` in
    `ranks` processes on this card, joined on a free localhost port;
    -> (wall s, each rank's stderr).  Every rank is stopped before this
    returns."""
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    # torch's own c10d warnings stay out of the compared stderr
    env = dict(os.environ, PYTHONPATH=ROOT, TORCH_CPP_LOG_LEVEL="ERROR")
    t = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bowtie_tpu_torch.parallel.launch",
         "--coordinator", f"localhost:{port}", "--num-hosts", str(ranks),
         "--host-id", str(k), "--", *cmd], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for k in range(ranks)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t
    rcs = [p.returncode for p in procs]
    require(rcs == [0] * ranks, f"launcher ranks exited {rcs}: {errs}")
    return wall, errs


def phase_cli_dist(work, device, base, gpu, ranks=DIST_RANKS):
    """The launcher: `ranks` ranks (rank k on cuda:{k mod the device
    count}: all on the one card by default), on phase cli_n's
    50,000-read file.  Each merged output (hits, --un, rank 0's stderr)
    must equal, byte for byte, what one process writes for the same
    command (cli_n's own run for bowtie's default command, where there
    is one); the one process's output is moved aside first, so that both
    name the same files in the SAM header's command line."""
    reads = os.path.join(work, "n_reads.fq")
    rows = {}
    for tag, opts, n_reads, dumps in (
            ("-n 2 -k 1 (default)", [], CLI_N_READS, ()),
            ("-v 0 -a -m 3 -S", ["-v", "0", "-a", "-m", "3", "-S"],
             CLI_N_READS, ()),
            (f"-v 0 -S -s {DIST_SKIP} -u {DIST_UPTO} --un",
             ["-v", "0", "-S", "-s", str(DIST_SKIP), "-u", str(DIST_UPTO),
              "--un", os.path.join(work, "dist.un.fq")], DIST_UPTO,
             (os.path.join(work, "dist.un.fq"),))):
        out = os.path.join(work, "n0.out" if not opts
                           else f"dist{len(rows)}.out")
        if os.path.exists(out + ".err"):        # cli_n's run of it
            with open(out + ".err") as f:
                want_err = f.read()
            single_s = None
        else:
            single_s, want_err = run_cli(
                opts + ["-x", base, reads, out], device)
        for f in (out,) + dumps:
            os.replace(f, f + ".single")
        wall, errs = launch_ranks(opts + ["-x", base, reads, out], ranks)
        for f in (out,) + dumps:
            with open(f, "rb") as a, open(f + ".single", "rb") as b:
                require(a.read() == b.read(), f"cli_dist {tag}: merged "
                        f"{os.path.basename(f)} differs from one process's")
        require(errs[0] == want_err, f"cli_dist {tag}: rank 0's stderr "
                f"differs from one process's: {errs[0]!r} {want_err!r}")
        require(all("# reads processed" not in e for e in errs[1:]),
                f"cli_dist {tag}: a rank but 0 printed a summary")
        rows[tag] = {"ranks": ranks, "wall_s": wall,
                     "reads_per_s": n_reads / wall, "single_wall_s": single_s,
                     "equal_files": [os.path.basename(f)
                                     for f in (out,) + dumps],
                     "summary": errs[0].strip().splitlines()}
    cards = min(ranks, torch.cuda.device_count())
    emit({"phase": "cli_dist", "gpu": gpu, "reads": CLI_N_READS,
          "cards": cards,
          "note": (f"{ranks} ranks share {cards} card(s): not a scaling "
                   "figure" if cards < ranks else
                   f"{ranks} ranks, one card each"), "runs": rows})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.time()
    device = torch.device("cuda")
    work = os.path.join(ROOT, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(args.seed)

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t = time.time()
    kernels.build(force=True)
    build_s = time.time() - t
    require(ilv.ilv_local_bytes() == 0,
            f"K13 has a stack: {ilv.ilv_local_bytes()} local bytes")
    emit({"phase": "device", "gpu": gpu,
          "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s,
          # the local memory per thread of K10's two instantiations
          # (K10/K10r; K14), reserved for every resident thread
          "best_machine_local_bytes": bd.machine_local_bytes(),
          # the stack frame, spills and registers of K10's two
          # instantiations and of K7's two layouts
          "best_machine_ptxas": k7_ptxas("best_machine"),
          "dfs_machine_ptxas": k7_ptxas(),
          # and of K13
          "ilv_kernel_ptxas": k7_ptxas("ilv_kernel"),
          "ilv_kernel_local_bytes": ilv.ilv_local_bytes(),
          # and of K6 and K9
          "jobs_ptxas": {k: k7_ptxas(k) for k in ("derive_rows",
                                                   "derive_b_jobs")},
          "jobs_local_bytes": dfs.jobs_local_bytes()})
    phase_s = {}

    def timed(name, fn, *a):
        t = time.time()
        res = fn(*a)
        phase_s[name] = time.time() - t
        return res

    seg_len = 2000
    genome, rep_starts, base, idx, fm, fm_sa = timed(
        "index", phase_index, rng, work, device, 4_600_000, 64, seg_len)
    stats, runs, check_sais = timed(
        "build", phase_build, np.random.default_rng(args.seed + 1), work,
        device, genome, base, gpu)
    k_stats, k_launches, strands = timed(
        "kernels", phase_kernels, rng, device, genome, rep_starts, seg_len,
        fm, fm_sa, 1 << 20)
    stats.update(k_stats)
    runs["kernels"] = k_launches
    idx_bw = read_ebwt(base + ".rev")
    golden = (GoldenFM(idx), GoldenFM(idx_bw))      # the host oracle's
    stats.update(timed("dfs", phase_dfs, rng, work, device, genome,
                       rep_starts, seg_len, idx, idx_bw, golden))
    timed("build_sais", check_sais)
    cli_runs, k3_batches = timed("cli", phase_cli, rng, work, device, genome,
                                 rep_starts, seg_len, base, idx, fm_sa,
                                 CLI_READS, gpu)
    runs.update(cli_runs)
    # K3 walk held to plain on the rows of the CLI's -a batch
    stats["K3w"]["cli_a_batches"] = k3_batches
    runs.update(timed("cli_v", phase_cli_v, rng, work, device, genome,
                      rep_starts, seg_len, base, idx, idx_bw, golden,
                      CLI_READS, gpu))
    n_stats, k7_b_ms = timed("n", phase_n, rng, work, device, genome,
                             rep_starts, seg_len, idx, idx_bw)
    # K6's line: the CLI's largest launch (launch B of one batch); phase
    # dfs's -v 2 -a -m 3 table beside it
    n_stats["K6"]["at_dfs_case"] = {k: stats["K6"][k] for k in (
        "ms", "plain_ms", "bound_ms", "rows")}
    stats.update(n_stats)
    stats["K7"]["launch_b_ms"] = k7_b_ms
    runs.update(timed("cli_n", phase_cli_n, rng, work, device, base, idx,
                      idx_bw, golden, genome, rep_starts, seg_len,
                      CLI_N_READS, gpu))
    stats.update(timed("best", phase_best, rng, work, device, genome,
                       rep_starts, seg_len, idx, idx_bw))
    best_runs, k10_batch = timed("cli_best", phase_cli_best, rng, work,
                                 device, base, genome, rep_starts, seg_len,
                                 gpu)
    runs.update(best_runs)
    stats["K10"]["cli_batch"] = k10_batch
    refs = unpack_reference(*read_bitpair_reference(base), plen=idx.plen)
    stats.update(timed("pe", phase_pe, rng,
                       np.random.default_rng(args.seed + 2), work, device,
                       genome, rep_starts, seg_len, idx, idx_bw, refs))
    # its own generator (seed + 3): every later phase reads what it read
    # before this phase existed
    timed("pev2", phase_pev2, np.random.default_rng(args.seed + 3), work,
          device, genome, rep_starts, seg_len, idx, idx_bw, refs)
    pe_runs, k13_batch, k14_batch = timed(
        "cli_pe", phase_cli_pe, rng, work, device, base, genome, rep_starts,
        seg_len, gpu)
    runs.update(pe_runs)
    runs["mesh"] = timed("mesh", phase_mesh, work, device, idx, idx_bw, fm,
                         strands)
    timed("cli_dist", phase_cli_dist, work, device, base, gpu)
    # K13's line: the CLI's first batch, the main path's shape; the 512
    # pairs of phase pe beside it
    k13 = stats["K13"]
    k13["at_512_pairs"] = {k: k13[k] for k in K13_KEYS}
    k13.update({k: k13_batch[k] for k in K13_KEYS},
               policy="-1/-2 default, the CLI's first batch (round 1)",
               shape=ilv.ilv_shape(k13_batch["lanes"], k13_batch["Lq"]),
               window=ilv.ilv_window(k13_batch["SPAN"], k13_batch["Lq"]),
               ptxas=k7_ptxas("ilv_kernel"),
               local_bytes=ilv.ilv_local_bytes())
    # K14's: the CLI's first --best batch
    stats["K14"] = dict(k14_batch, pairs=CLI_BATCH)
    counter = {"K2": "exact_ranges", "K12": "exact_ranges_cat",
               "K3w": "resolve_rows_walk", "K3t": "walk_table",
               "K3s": "resolve_rows_sa", "K4": "one_row",
               "K6": "derive_rows", "K7": "dfs_machine", "K8": "dfs_pack",
               "K9": "derive_b_jobs", "K10": "best_machine",
               "K10r": "best_record", "K11": "best_pack",
               "K14": "best_pev2",
               "K13": "pe_ilv", "K16": "sa_round",
               "K15": "align_step", "K3r": "bwt_rows_offsets"}
    main_path = [r for r in runs if r.startswith("cli ")]
    # K15 and the K3 remainder: no CLI path runs them (nor does the
    # reference's CLI); their launches are phase kernels' and phase mesh's
    off_cli = {"K15": ("kernels", "mesh"), "K3r": ("kernels", "mesh")}
    rows = []
    for key, entry in stats.items():
        c = counter[key]
        # launches: the main path's, the CLI runs; K3 dense runs only in
        # the library run, and has 0 here
        entry["launches"] = sum(runs[r][c]
                                for r in off_cli.get(key, main_path))
        entry["launches_by_run"] = {r: n[c] for r, n in runs.items()}
        require(key == "K3s" or entry["launches"] > 0,
                f"{key} never ran on the main path"
                + (" or in phases kernels and mesh" if key in off_cli
                   else ""))
        entry["gpu"] = gpu
        rows.append(entry)
    emit({"kernels": rows})
    emit({"phase_s": phase_s, "total_s": time.time() - t0})
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

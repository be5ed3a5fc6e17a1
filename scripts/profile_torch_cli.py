#!/usr/bin/env python3
"""Where the time of the port's CLI goes, on one CUDA device.

    python3 scripts/profile_torch_cli.py [--seed N] [--reads 200000]
        [--pairs 12000] [--configs a,b,...] [--no-cprofile] [--kernels]

Builds chip_smoke.py's seeded 4.6 Mbp genome index, reads and pairs, then
runs bowtie_tpu_torch.cli.align.main on each configuration: the
single-end modes (-v 0 -k 1, -v 0 -a -m 3 -S, -v 1 -k 1, -v 2 -a -m 3
-S, bowtie's default command -n 2 -k 1, -n 2 -a -m 3 -S), the best-first
modes (-v 2 -m 1 --best --strata -S, -n 2 --best -k 1, on --reads reads
of chip_smoke.py's n mix) and the paired modes (the default -1/-2, -v 2
-a -m 1 -S and --best, on --pairs pairs of its pe_pairs mix).  Each
configuration runs a warm-up, a timed run (wall s, reads or pairs a
second, lanes re-run on the host oracle), unless --no-cprofile a run
under cProfile for the host breakdown (the top functions by own time,
and the time inside the host oracle's align_read) and a run under
torch.profiler for the device's busy time (the sum of kernel and copy
time on the card over that run's wall time) and its split by kernel
(seconds and calls).  Prints one JSON line per configuration, then the
cProfile tables.  --kernels first times K2, K3 walk-left and K4 as the
CLI's exact gate runs them, on one CLI batch (8,192 reads, 16,384
strands) and on 2^20 reads (2^21 strands, chip_smoke.py phase kernels'
size), medians of 20 CUDA-event timings, and records the BWT rows of
every K3 walk-left launch of the configurations' timed runs: for each, its
row count, walk steps, longest walk and bound (chip_smoke.py's K3 walk
bound, the steps counted by resolve_rows_plain on the card), the warp
efficiency of its schedule and K3's time on those rows; and of every K4
launch, its strands, steps, longest chain and K4's time on them.
"""
from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from bowtie_tpu_torch.align import dfs_device as dfs  # noqa: E402
from bowtie_tpu_torch.align import pipeline  # noqa: E402
from bowtie_tpu_torch.align.exact import (  # noqa: E402
    exact_ranges, resolve_rows, resolve_rows_lanes, resolve_rows_plain,
    walk_table)
from bowtie_tpu_torch.align.pipeline import (  # noqa: E402
    one_row, one_row_plain)
from bowtie_tpu_torch.build.builder import build_index  # noqa: E402
from bowtie_tpu_torch.cli import align as cli  # noqa: E402
from bowtie_tpu_torch.index.arrays import from_ebwt  # noqa: E402
from bowtie_tpu_torch.index.ebwt_io import read_ebwt  # noqa: E402

# name -> (flags, reads: chip_smoke's make_reads mix ("exact"), its
# cli_v mix ("mm", a second mismatch in every fourth read), its cli_n
# mix ("n", three mismatches in every third read, qualities Phred 2-40)
# or its pe_pairs mix ("pairs", 2 x 50 bp --fr mates))
CONFIGS = {"k1": (["-v", "0", "-k", "1"], "exact"),
           "a_m3_S": (["-v", "0", "-a", "-m", "3", "-S",
                       "--batch-size", "65536"], "exact"),
           "v1_k1": (["-v", "1", "-k", "1"], "mm"),
           "v2_a_m3_S": (["-v", "2", "-a", "-m", "3", "-S"], "mm"),
           "n2_k1": ([], "n"),             # bowtie's default command
           "n2_a_m3_S": (["-n", "2", "-a", "-m", "3", "-S"], "n"),
           "v2_m1_best_strata_S": (["-v", "2", "-m", "1", "--best",
                                    "--strata", "-S"], "n"),
           "n2_best_k1": (["-n", "2", "--best", "-k", "1"], "n"),
           "pe_default": ([], "pairs"),    # the default paired command
           "pe_v2_a_m1_S": (["-v", "2", "-a", "-m", "1", "-S"], "pairs"),
           "pe_best": (["--best"], "pairs")}
CLI_BATCH = 8192                # the CLI's --batch-size default


def kernel_batch_ms(rng, genome, rep, base, n_reads):
    """K2, K3 walk-left (over K2's hit top rows) and K4 on n_reads reads of
    chip_smoke.py's make_reads mix, both strands, as the CLI's exact gate
    launches them: medians of 20 CUDA-event timings (chip_smoke.time_ms)."""
    dev = torch.device("cuda")
    fm = from_ebwt(read_ebwt(base), device=dev)
    codes, lens, *_ = cs.make_reads(rng, genome, rep, 2000, n_reads)
    mat_np, lens_np = cs.strand_matrix(codes, lens)
    mat = torch.from_numpy(mat_np).to(dev)
    lens2 = torch.from_numpy(lens_np).to(dev)
    seeds = torch.from_numpy(rng.integers(0, 2**32, mat.shape[0],
                                          dtype=np.uint64).astype(np.int64)
                             ).to(dev)
    top, bot = exact_ranges(fm, mat, lens2)
    rows = top[bot > top].contiguous()
    return {"reads": n_reads, "strands": int(mat.shape[0]),
            "hit_rows": int(rows.numel()),
            "K2_ms": cs.time_ms(lambda: exact_ranges(fm, mat, lens2), dev,
                                20),
            "K3w_ms": cs.time_ms(lambda: resolve_rows(fm, rows), dev, 20),
            "K4_ms": cs.time_ms(lambda: one_row(fm, mat, lens2, seeds), dev,
                                20)}


def recorded(module, name, run_fn):
    """Run run_fn() with module.name (a kernel wrapper the CLI calls)
    wrapped to keep clones of its arguments; -> (the calls' arguments,
    run_fn's result)."""
    real, seen = getattr(module, name), []

    def rec(*a):
        seen.append([x.clone() if isinstance(x, torch.Tensor) else x
                     for x in a])
        return real(*a)
    setattr(module, name, rec)
    try:
        res = run_fn()
    finally:
        setattr(module, name, real)
    return seen, res


def k3_walk_launches(run_fn):
    """Run run_fn() with the CLI's K3 calls (align/pipeline.py) recorded;
    -> one dict per walk-left launch: its rows, walk steps, longest walk,
    the bound chip_smoke.py gives K3 walk for them, K3's time on them
    (median of 20) and the warp efficiency of its schedule (row steps over
    the lane slots of its warps' iterations, exact.resolve_rows_lanes),
    then run_fn's result."""
    seen, res = recorded(pipeline, "resolve_rows", run_fn)
    out = []
    dev = torch.device("cuda")
    for fm, rows in seen:
        if fm.sa is not None:
            continue
        m = rows.numel()
        walk = torch.zeros(2, m, dtype=torch.int64, device=dev)
        resolve_rows_plain(fm, rows, walk)
        steps, words = (int(x) for x in walk.sum(1))
        b = cs.bounds(cs._nbytes(walk_table(fm), fm.offs, rows) + 9 * m,
                      steps, steps, words,
                      cs.SECTORS_PER_WALK_STEP * steps + m)
        iters = resolve_rows_lanes(fm, rows)[2]
        slots = 32 * int(iters.sum())
        out.append(dict(rows=m, walk_steps=steps, max_walk=int(walk[0].max())
                        if m else 0, bound_ms=b["bound_ms"],
                        bound_by=b["bound_by"],
                        warp_efficiency=steps / max(1, slots),
                        ms=cs.time_ms(lambda: resolve_rows(fm, rows), dev,
                                      20)))
    return out, res


def k4_launches(run_fn):
    """Run run_fn() with the CLI's K4 calls (align/pipeline.py one_row)
    recorded; -> one dict per launch: its strands, LF and walk steps, the
    longest chain of one strand (one_row_plain's work count) and K4's
    time on them (median of 20), then run_fn's result."""
    seen, res = recorded(pipeline, "one_row", run_fn)
    out = []
    dev = torch.device("cuda")
    for fm, mat, lens, seeds in seen:
        n = mat.shape[0]
        work = torch.zeros(2, n, dtype=torch.int64, device=dev)
        one_row_plain(fm, mat, lens, seeds, work)
        out.append(dict(strands=n, steps=int(work[0].sum()),
                        max_chain=int(work[0].max()),
                        ms=cs.time_ms(lambda: one_row(fm, mat, lens, seeds),
                                      dev, 20)))
    return out, res


def run(args) -> float:
    t = time.time()
    with contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(args, device="cuda")
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"cli {args} exited {rc}")
    return time.time() - t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--pairs", type=int, default=12_000)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--no-cprofile", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_cli: no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    work = os.path.join(ROOT, ".smoke", "profile")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    genome, rep = cs.make_genome(rng, 4_600_000, 64, 2000)
    base = os.path.join(work, "genome")
    build_index([genome], ["synthetic_4.6M seeded"], base)
    codes, lens, *_ = cs.make_reads(rng, genome, rep, 2000, args.reads)
    reads = os.path.join(work, "reads.fq")
    cs.write_fastq(reads, codes, lens)
    paths = {"exact": reads, "mm": os.path.join(work, "mm_reads.fq"),
             "n": os.path.join(work, "n_reads.fq")}
    cs.mm_reads(rng, genome, rep, 2000, args.reads, paths["mm"])
    cs.n_reads(rng, genome, rep, 2000, args.reads, paths["n"])
    names = args.configs.split(",")
    if any(CONFIGS[n][1] == "pairs" for n in names):
        p1, p2 = (os.path.join(work, f"pairs_{k}.fq") for k in (1, 2))
        cs.pe_pairs(rng, genome, rep, 2000, args.pairs, p1, p2)
    if args.kernels:
        for n in (CLI_BATCH, 1 << 20):
            print(json.dumps({"kernels_at": kernel_batch_ms(
                rng, genome, rep, base, n), "gpu": gpu}), flush=True)

    tables = []
    for name in names:
        flags, kind = CONFIGS[name]
        inputs = ["-1", p1, "-2", p2] if kind == "pairs" else [paths[kind]]
        n = args.pairs if kind == "pairs" else args.reads
        argv = flags + ["-x", base, *inputs,
                        os.path.join(work, name + ".out")]
        run(argv)                                    # warm: build, caches
        dfs.FALLBACKS["lanes"] = 0
        wall = run(argv)
        row = {"config": name, "gpu": gpu,
               "pairs" if kind == "pairs" else "reads": n, "wall_s": wall,
               "per_s": n / wall,
               "oracle_fallback_lanes": dfs.FALLBACKS["lanes"]}
        if args.kernels and kind != "pairs":
            row["k3_walk_launches"], _ = k3_walk_launches(
                lambda: run(argv))
            row["k4_launches"], _ = k4_launches(lambda: run(argv))
        if not args.no_cprofile:
            prof = cProfile.Profile()
            prof.enable()
            row["cprofile_wall_s"] = run(argv)
            prof.disable()
            s = io.StringIO()
            st = pstats.Stats(prof, stream=s).sort_stats("tottime")
            st.print_stats(20)
            tables.append(f"== {name} ({gpu}) ==\n{s.getvalue()}")
            top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:8]
            row["host_top_tottime"] = [
                {"fn": f"{os.path.basename(k[0])}:{k[1]}:{k[2]}",
                 "tottime_s": v[2]} for k, v in top]
            row["cprofile_oracle_s"] = sum(
                v[3] for k, v in st.stats.items()
                if k[0].endswith("drivers.py") and k[2] == "align_read")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as tp:
            traced_wall = run(argv)
        events = tp.key_averages()
        device_us = sum(e.self_device_time_total for e in events)
        by_kernel = sorted(((e.key, e.self_device_time_total / 1e6, e.count)
                            for e in events if e.self_device_time_total),
                           key=lambda kv: -kv[1])[:12]
        row.update(device_s_by_kernel={k: t for k, t, _ in by_kernel},
                   device_calls_by_kernel={k: c for k, _, c in by_kernel},
                   traced_wall_s=traced_wall, device_busy_s=device_us / 1e6,
                   device_busy_share=device_us / 1e6 / traced_wall)
        print(json.dumps(row), flush=True)
    print("\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())

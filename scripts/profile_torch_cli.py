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
size), medians of 20 CUDA-event timings.
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
from bowtie_tpu_torch.align.exact import (  # noqa: E402
    exact_ranges, resolve_rows)
from bowtie_tpu_torch.align.pipeline import one_row  # noqa: E402
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

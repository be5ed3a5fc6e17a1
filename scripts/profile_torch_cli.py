#!/usr/bin/env python3
"""Where the time of the port's CLI goes, on one CUDA device.

    python3 scripts/profile_torch_cli.py [--seed N] [--reads 200000]

Builds chip_smoke.py's seeded 4.6 Mbp genome index and reads, then runs
bowtie_tpu_torch.cli.align.main four times per configuration (-v 0 -k 1,
-v 0 -a -m 3 -S, -v 1 -k 1, -v 2 -a -m 3 -S, bowtie's default command
-n 2 -k 1, -n 2 -a -m 3 -S): a warm-up, a timed run
(wall s, reads/s, lanes re-run on the host oracle), a run under cProfile
for the host breakdown (the top functions by own time, and the time
inside the host oracle's align_read) and a run under torch.profiler for
the device's busy time (the sum of kernel and copy time on the card over
that run's wall time) and its split by kernel.  Prints one JSON line per
configuration, then the cProfile tables.
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
from bowtie_tpu_torch.build.builder import build_index  # noqa: E402
from bowtie_tpu_torch.cli import align as cli  # noqa: E402

# name -> (flags, reads: chip_smoke's make_reads mix ("exact"), its
# cli_v mix ("mm", a second mismatch in every fourth read) or its cli_n
# mix ("n", three mismatches in every third read, qualities Phred 2-40))
CONFIGS = {"k1": (["-v", "0", "-k", "1"], "exact"),
           "a_m3_S": (["-v", "0", "-a", "-m", "3", "-S",
                       "--batch-size", "65536"], "exact"),
           "v1_k1": (["-v", "1", "-k", "1"], "mm"),
           "v2_a_m3_S": (["-v", "2", "-a", "-m", "3", "-S"], "mm"),
           "n2_k1": ([], "n"),             # bowtie's default command
           "n2_a_m3_S": (["-n", "2", "-a", "-m", "3", "-S"], "n")}


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

    tables = []
    for name, (flags, kind) in CONFIGS.items():
        argv = flags + ["-x", base, paths[kind],
                        os.path.join(work, name + ".out")]
        run(argv)                                    # warm: build, caches
        dfs.FALLBACKS["lanes"] = 0
        wall = run(argv)
        fallbacks = dfs.FALLBACKS["lanes"]
        prof = cProfile.Profile()
        prof.enable()
        prof_wall = run(argv)
        prof.disable()
        s = io.StringIO()
        st = pstats.Stats(prof, stream=s).sort_stats("tottime")
        st.print_stats(20)
        tables.append(f"== {name} ({gpu}) ==\n{s.getvalue()}")
        top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:8]
        host_top = [{"fn": f"{os.path.basename(k[0])}:{k[1]}:{k[2]}",
                     "tottime_s": v[2]} for k, v in top]
        oracle_s = sum(v[3] for k, v in st.stats.items()
                       if k[0].endswith("drivers.py")
                       and k[2] == "align_read")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as tp:
            traced_wall = run(argv)
        events = tp.key_averages()
        device_us = sum(e.self_device_time_total for e in events)
        by_kernel = sorted(((e.key, e.self_device_time_total / 1e6)
                            for e in events if e.self_device_time_total),
                           key=lambda kv: -kv[1])[:8]
        print(json.dumps({
            "config": name, "gpu": gpu, "reads": args.reads,
            "wall_s": wall, "reads_per_s": args.reads / wall,
            "oracle_fallback_lanes": fallbacks,
            "cprofile_oracle_s": oracle_s,
            "device_s_by_kernel": dict(by_kernel),
            "cprofile_wall_s": prof_wall, "traced_wall_s": traced_wall,
            "device_busy_s": device_us / 1e6,
            "device_busy_share": device_us / 1e6 / traced_wall,
            "host_top_tottime": host_top}), flush=True)
    print("\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())

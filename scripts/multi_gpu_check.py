#!/usr/bin/env python3
"""The port's scale-out paths across every CUDA device of one machine.

    python3 scripts/multi_gpu_check.py [--seed N]

Builds chip_smoke.py's seeded 4.6 Mbp index (phase index) and draws, from
a generator of its own, 2^20 of its 36 bp reads (2^21 strands, the
kernels phase's mix), 16,384 reads of the dfs phase's mix and 100,000 of
the cli_n phase's.  Then chip_smoke.py's phase mesh with one mesh entry
per device: K15 with each shard launched on its own card's stream
(kernels.launch), the K3 remainder on each shard, run_sharded (K6, K7)
over the devices, each held to one launch on cuda:0; and its phase
cli_dist with one launcher rank per device (rank k on cuda:k), each
merged output held byte for byte to one process's run on cuda:0.  Any
disagreement raises.  Prints one JSON line per phase and, last, the
card's name and power limit and the device count.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from bowtie_tpu_torch import kernels  # noqa: E402
from bowtie_tpu_torch.index.ebwt_io import read_ebwt  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("multi_gpu_check: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ndev = torch.cuda.device_count()
    devices = [torch.device("cuda", k) for k in range(ndev)]
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    work = os.path.join(ROOT, ".smoke_multi")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    kernels.build()
    rng = np.random.default_rng(args.seed)
    seg_len = 2000
    genome, rep_starts, base, idx, fm, _fm_sa = cs.phase_index(
        rng, work, device, 4_600_000, 64, seg_len)
    idx_bw = read_ebwt(base + ".rev")
    codes, lens, *_ = cs.make_reads(rng, genome, rep_starts, seg_len,
                                    1 << 20)
    strands = cs.strand_matrix(codes, lens)
    cs.mm_reads(rng, genome, rep_starts, seg_len, cs.DFS_READS,
                os.path.join(work, "dfs.fq"))
    cs.n_reads(rng, genome, rep_starts, seg_len, cs.CLI_N_READS,
               os.path.join(work, "n_reads.fq"))
    cs.phase_mesh(work, device, idx, idx_bw, fm, strands, devices)
    cs.phase_cli_dist(work, device, base, gpu, ranks=ndev)
    shutil.rmtree(work, ignore_errors=True)
    print(gpu, flush=True)
    print(f"devices {ndev}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

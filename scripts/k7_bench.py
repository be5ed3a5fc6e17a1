#!/usr/bin/env python3
"""K7 (the GreedyDFS machine, csrc/dfs.cu) timed on seeded inputs, for
one source tree at a time, so that two trees can be compared on one card
in one sitting.

    python3 scripts/k7_bench.py --root DIR --tag NAME [--cases a,b,...]
                                [--reps N] [--diag]
    python3 scripts/k7_bench.py --compare NAME NAME ...

The first form imports bowtie_tpu_torch from DIR (its kernels are built
there) and runs dfs_device.run_machine on each case: the median and
spread of --reps timed calls (CUDA events behind a spin kernel, as
chip_smoke.py times), the per-lane transitions summarised
(utils/kdiag.py lane_stats: max, p50, p99, mean, warp efficiency), and
with --diag the slowest lane alone and its warp's 32 lanes alone.  It
writes NAME.json and, per case, the outputs and per-lane transitions as
NAME.CASE.npz under the work directory (.scratch/k7bench of the tree
this script is in).  The second form holds every NAME's outputs and
per-lane transitions to the first NAME's, case by case, and prints each
case's times side by side; it raises on a difference.

Cases (inputs from --seed; the genome and index are built once, into the
work directory, by the first run that needs them):
  v2_16k    -v 2 -a -m 3, 16,384 reads of chip_smoke.py's dfs mix (a
            second mismatch in every fourth read), the 4.6 Mbp genome
            with 64 copies of a 2 kb segment, dense SA pair
  v2_8k     the first 8,192 of them (the CLI's batch)
  walk      -v 1 -k 1, 4,096 of them, the pair thinned to offRate 13
            (walk-left), max_steps 2,000
  nb_n2     -n 2 -k 1 launch B (launch A, K9 and K6 first), 16,384
            reads of chip_smoke.py's n mix
  nb_n3     -n 3 -l 20 -a -m 3 launch B, the same reads
  big_v2    -v 2 -a -m 3, 16,384 reads on a seeded 100 Mbp genome (C.
            elegans' size; index built with the suffix array on the
            card): the pair's rank data exceed the 50 MB L2
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(HERE, ".scratch", "k7bench")
READ_LEN = 36
COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)
INF32 = 0x7FFFFFFF
LANES = 16384                 # reads of the -v and -n cases
ALL_CASES = ("v2_16k", "v2_8k", "walk", "nb_n2", "nb_n3", "big_v2")


def _kdiag():
    """utils/kdiag.py of this script's own tree (it imports numpy only),
    whatever tree --root names."""
    spec = importlib.util.spec_from_file_location(
        "k7bench_kdiag",
        os.path.join(HERE, "bowtie_tpu_torch", "utils", "kdiag.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- inputs

def make_genome(rng, length, copies, seg_len):
    g = rng.integers(0, 4, length).astype(np.uint8)
    seg = rng.integers(0, 4, seg_len).astype(np.uint8)
    slice_len = length // copies
    starts = (np.arange(copies) * slice_len
              + rng.integers(0, slice_len - seg_len, copies))
    for s in starts:
        g[s:s + seg_len] = seg
    return g, starts


def make_reads(rng, genome, rep_starts, seg_len, n):
    """chip_smoke.py's read mix: 60 % exact, 10 % of the repeat, 10 %
    one mismatch, 5 % one N, 5 % short, 10 % random; then a second
    mismatch in every fourth read."""
    L = READ_LEN
    kind = rng.choice(6, size=n, p=(0.60, 0.10, 0.10, 0.05, 0.05, 0.10))
    pos = rng.integers(0, len(genome) - L, n)
    rep = kind == 1
    pos[rep] = (rep_starts[rng.integers(0, len(rep_starts), rep.sum())]
                + rng.integers(0, seg_len - L, rep.sum()))
    codes = genome[pos[:, None] + np.arange(L)]
    rc = rng.integers(0, 2, n) == 1
    codes[rc] = COMP[codes[rc, ::-1]]
    rows = np.arange(n)
    col = rng.integers(0, L, n)
    mm = kind == 2
    codes[rows[mm], col[mm]] = (codes[rows[mm], col[mm]]
                                + rng.integers(1, 4, mm.sum())) % 4
    nk = kind == 3
    codes[rows[nk], col[nk]] = 4
    rnd = kind == 5
    codes[rnd] = rng.integers(0, 4, (rnd.sum(), L))
    lens = np.full(n, L, dtype=np.int32)
    sh = kind == 4
    lens[sh] = rng.integers(5, 10, sh.sum())
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    r4 = np.arange(0, n, 4)
    c4 = rng.integers(0, L, len(r4))
    c = codes[r4, c4]
    codes[r4, c4] = np.where(c < 4, (c + 1) % 4, c)
    return codes, lens


def write_fastq(path, codes, lens, quals=None):
    with open(path, "wb") as f:
        for i, (row, ln) in enumerate(zip(codes, lens)):
            q = (b"I" * ln if quals is None
                 else (quals[i, :ln] + 33).astype(np.uint8).tobytes())
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, CHARS[row[:ln]].tobytes(), q))


def n_mix(rng, codes):
    """chip_smoke.py's n mix on top of make_reads': three mismatches in
    every third read, qualities Phred 2-40."""
    codes = codes.copy()
    n = len(codes)
    rows = np.arange(0, n, 3)
    cols = np.argsort(rng.random((len(rows), READ_LEN)), 1)[:, :3]
    c = codes[rows[:, None], cols]
    codes[rows[:, None], cols] = np.where(
        c < 4, (c + rng.integers(1, 4, c.shape)) % 4, c)
    return codes, rng.integers(2, 41, (n, READ_LEN))


# ---------------------------------------------------------------- worker

class Tree:
    """The modules of the tree under test."""

    def __init__(self, root):
        sys.path.insert(0, os.path.abspath(root))
        import torch
        from bowtie_tpu_torch import kernels
        from bowtie_tpu_torch.align import dfs_device, n_device
        from bowtie_tpu_torch.align.backtrack_oracle import QUAL_ROUNDS
        from bowtie_tpu_torch.align.dfs_jobs import (build_n_jobs_a_vec,
                                                     build_v_jobs_vec)
        from bowtie_tpu_torch.build import sa
        from bowtie_tpu_torch.build.builder import build_index
        from bowtie_tpu_torch.index.ebwt_io import read_ebwt
        from bowtie_tpu_torch.io.readers import ReadSource
        from bowtie_tpu_torch.utils.rng import fill_seed_caches
        self.torch, self.kernels, self.D, self.N = (torch, kernels,
                                                     dfs_device, n_device)
        self.qual_rounds = QUAL_ROUNDS
        self.v_jobs, self.n_jobs = build_v_jobs_vec, build_n_jobs_a_vec
        self.sa, self.build_index, self.read_ebwt = sa, build_index, read_ebwt
        self.ReadSource, self.seeds_of = ReadSource, fill_seed_caches
        self.root = os.path.abspath(root)

    def run(self, pair, jobs, seeds, c0, kw):
        """run_machine's outputs and its per-lane transitions.  A tree
        whose wrapper returns only their maximum has its per-lane tensor
        caught where the wrapper allocates it."""
        D, torch = self.D, self.torch
        if hasattr(D, "run_machine_lanes"):
            return D.run_machine_lanes(pair, jobs, seeds, c0, **kw)
        made = []

        class Catch:
            def __getattr__(self, k):
                return getattr(torch, k)

            def empty(self, *a, **k):
                t = torch.empty(*a, **k)
                made.append(t)
                return t
        D.torch = Catch()
        try:
            out, _ = D.run_machine(pair, jobs, seeds, c0, **kw)
        finally:
            D.torch = torch
        return out, made[list(D._OUT_SHAPES).index("steps")]


def ensure_index(T, base, length, seed, device_sa):
    if os.path.exists(base + ".rev.2.ebwt"):
        return
    rng = np.random.default_rng(seed)
    genome, _ = make_genome(rng, length, 64, 2000)
    kw = {}
    if device_sa:
        kw["sa_fn"] = functools.partial(T.sa.suffix_array_doubling,
                                        device=T.torch.device("cuda"))
    t = time.time()
    T.build_index([genome], [f"synthetic_{length} seeded"], base,
                  off_rate=5, ftab_chars=10, **kw)
    print(json.dumps({"built": base, "bp": length, "s": time.time() - t}),
          flush=True)


def genome_of(length, seed):
    return make_genome(np.random.default_rng(seed), length, 64, 2000)


def reads_of(T, path, genome, starts, seed, n, nmix=False):
    rng = np.random.default_rng(seed)
    codes, lens = make_reads(rng, genome, starts, 2000, n)
    quals = None
    if nmix:
        codes, quals = n_mix(rng, codes)
    write_fastq(path, codes, lens, quals)
    return list(T.ReadSource([path]).records())


def v_case(T, pair, reads, v, n_k, m_max, steps, dev):
    D, torch = T.D, T.torch
    jobs, _ = T.v_jobs(reads, v, False, False, 40)
    base = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        np.stack([jobs[f] for f in D.JOB_FIELDS], -1).astype(np.int32),
        jobs["base_codes"], jobs["base_qual"], jobs["base_plen"])]
    scal, qqp = D.derive_rows(*base, pair.ftab_chars)
    seeds = torch.from_numpy(
        T.seeds_of(reads, 0).astype(np.int64)).to(dev)
    c0 = torch.zeros(len(reads), dtype=torch.int32, device=dev)
    return ({"scal": scal, "qqp": qqp}, seeds, c0,
            dict(n_k=n_k, m_max=m_max, max_steps=steps))


def nb_case(T, pair, reads, n, s, qt, n_k, m_max, dev):
    """Launch B's inputs: launch A run on the card, then K9 and K6."""
    D, N, torch = T.D, T.N, T.torch
    fc = pair.ftab_chars
    L = D._len_bucket(max(READ_LEN, s))
    jobs, _, gated_np, jrc, _ = T.n_jobs(reads, n, s, qt, 125, True,
                                         False, False, L)
    base = [torch.from_numpy(np.ascontiguousarray(jobs[k])).to(dev)
            for k in ("base_codes", "base_qual", "base_plen")]
    seeds = torch.from_numpy(
        T.seeds_of(reads, 0).astype(np.int64)).to(dev)
    c0 = torch.zeros(len(reads), dtype=torch.int32, device=dev)
    kw = dict(n_k=n_k, m_max=m_max, max_steps=60000)
    out_a, _ = D.run_machine(pair, D.upload_jobs(jobs, fc, dev), seeds, c0,
                             **kw)
    qr = torch.from_numpy(T.qual_rounds.astype(np.int32)).to(dev)
    scal_b = N.derive_b_jobs(out_a, torch.from_numpy(gated_np).to(dev),
                             base[1], base[2], qr, J=N.J_B, jrc=jrc, n=n,
                             s=s, qt=qt, maxbts=125, maq=True, norc=False,
                             nofw=False)
    scal, qqp = D.derive_rows(scal_b, *base, fc)
    return {"scal": scal, "qqp": qqp}, seeds, out_a["count"], kw


def time_ms(torch, fn, reps):
    for _ in range(2):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def sub(jobs, seeds, c0, lo, hi):
    return ({k: v[lo:hi].contiguous() for k, v in jobs.items()},
            seeds[lo:hi].contiguous(), c0[lo:hi].contiguous())


def worker(args) -> int:
    T = Tree(args.root)
    torch, D = T.torch, T.D
    if not torch.cuda.is_available():
        print("k7_bench: no CUDA device", file=sys.stderr)
        return 2
    kd = _kdiag()
    dev = torch.device("cuda")
    os.makedirs(args.work, exist_ok=True)
    t = time.time()
    T.kernels.lib()
    with open(os.path.join(T.root, "bowtie_tpu_torch", "csrc", "build",
                           "ptxas.txt")) as f:
        report = kd.ptxas_entry(f.read(), "dfs_machine")
    res = {"root": T.root, "tag": args.tag,
           "kernel_build_s": time.time() - t, "ptxas": report, "cases": {}}
    cases = args.cases.split(",")
    small = os.path.join(args.work, "g46")
    ensure_index(T, small, 4_600_000, args.seed, False)
    genome, starts = genome_of(4_600_000, args.seed)
    idx, idx_bw = T.read_ebwt(small), T.read_ebwt(small + ".rev")
    dense = D.build_fmpair(idx, idx_bw, dev, dense_sa=True)
    reads = reads_of(T, os.path.join(args.work, f"v.{args.tag}.fq"), genome,
                     starts, args.seed + 1, LANES)
    inputs = {}
    if "v2_16k" in cases:
        inputs["v2_16k"] = (dense,) + v_case(T, dense, reads, 2, INF32, 3,
                                             20000, dev)
    if "v2_8k" in cases:
        inputs["v2_8k"] = (dense,) + v_case(T, dense, reads[:LANES // 2], 2,
                                            INF32, 3, 20000, dev)
    if "walk" in cases:
        thin = D.build_fmpair(idx.with_off_rate(idx.off_rate + 8),
                              idx_bw.with_off_rate(idx_bw.off_rate + 8),
                              dev, dense_sa=False)
        inputs["walk"] = (thin,) + v_case(T, thin, reads[:LANES // 4], 1, 1,
                                          INF32, 2000, dev)
    if "nb_n2" in cases or "nb_n3" in cases:
        nreads = reads_of(T, os.path.join(args.work, f"n.{args.tag}.fq"),
                          genome, starts, args.seed + 2, LANES, nmix=True)
        if "nb_n2" in cases:
            inputs["nb_n2"] = (dense,) + nb_case(T, dense, nreads, 2, 28, 70,
                                                 1, INF32, dev)
        if "nb_n3" in cases:
            inputs["nb_n3"] = (dense,) + nb_case(T, dense, nreads, 3, 20, 70,
                                                 INF32, 3, dev)
    if "big_v2" in cases:
        big = os.path.join(args.work, "g100")
        ensure_index(T, big, 100_000_000, args.seed + 5, True)
        bgen, bstarts = genome_of(100_000_000, args.seed + 5)
        bidx, bidx_bw = T.read_ebwt(big), T.read_ebwt(big + ".rev")
        bpair = D.build_fmpair(bidx, bidx_bw, dev, dense_sa=True)
        breads = reads_of(T, os.path.join(args.work, f"b.{args.tag}.fq"),
                          bgen, bstarts, args.seed + 3, LANES)
        inputs["big_v2"] = (bpair,) + v_case(T, bpair, breads, 2, INF32, 3,
                                             20000, dev)
        res["big_rank_bytes"] = sum(
            t.numel() * t.element_size() for fm in (bpair.fw, bpair.bw)
            for t in (fm.bwt, fm.occ))
    for name in cases:
        pair, jobs, seeds, c0, kw = inputs[name]
        out, steps = T.run(pair, jobs, seeds, c0, kw)
        torch.cuda.synchronize()
        st = steps.cpu().numpy()
        np.savez(os.path.join(args.work, f"{args.tag}.{name}.npz"),
                 steps=st, **{k: out[k].cpu().numpy() for k in D.OUT_KEYS})
        times = time_ms(torch, lambda: T.run(pair, jobs, seeds, c0, kw),
                        args.reps)
        row = dict(lanes=int(seeds.numel()), L=int(jobs["qqp"].shape[2] // 3),
                   J=int(jobs["scal"].shape[1]), ms=statistics.median(times),
                   ms_min=min(times), ms_max=max(times),
                   lanes_stats=kd.lane_stats(st))
        if args.diag:
            ls = row["lanes_stats"]
            b, w = ls["slowest_lane"], ls["slowest_warp"]
            one = sub(jobs, seeds, c0, b, b + 1)
            row["slowest_lane_ms"] = statistics.median(time_ms(
                torch, lambda: T.run(pair, *one, kw), 5))
            ww = sub(jobs, seeds, c0, w, min(w + 32, len(st)))
            row["slowest_warp_ms"] = statistics.median(time_ms(
                torch, lambda: T.run(pair, *ww, kw), 5))
        res["cases"][name] = row
        print(json.dumps({name: row}), flush=True)
    res["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    with open(os.path.join(args.work, f"{args.tag}.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps({"tag": args.tag, "ptxas": res["ptxas"],
                      "gpu": res["gpu"]}), flush=True)
    return 0


def compare(args) -> int:
    runs = [json.load(open(os.path.join(args.work, f"{t}.json")))
            for t in args.compare]
    first = args.compare[0]
    table = {}
    for name in runs[0]["cases"]:
        ref = np.load(os.path.join(args.work, f"{first}.{name}.npz"))
        for r in runs:
            got = np.load(os.path.join(args.work, f"{r['tag']}.{name}.npz"))
            for k in ref.files:
                if not np.array_equal(ref[k], got[k]):
                    raise SystemExit(f"{name}: {r['tag']} differs from "
                                     f"{first} in {k}")
        table[name] = {r["tag"]: [r["cases"][name]["ms"],
                                  r["cases"][name]["ms_min"],
                                  r["cases"][name]["ms_max"]] for r in runs}
    print(json.dumps({"equal_outputs_and_steps": True,
                      "ms_median_min_max": table,
                      "gpu": runs[0].get("gpu")}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--cases", default=",".join(ALL_CASES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--diag", action="store_true")
    ap.add_argument("--work", default=WORK)
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args()
    return compare(args) if args.compare else worker(args)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""K6 and K9 (the job-table kernels of -v and -n: derive_rows_kernel and
derive_b_jobs_kernel) timed on the CLI's own job tables, for one source
tree at a time, so that two trees can be compared on one card in one
sitting.

    python3 scripts/jobs_bench.py --root DIR --tag NAME [--cases a,b,...]
                                  [--reps N]
    python3 scripts/jobs_bench.py --compare NAME NAME ...

The first form imports bowtie_tpu_torch from DIR (its kernels are built
there), builds each case's inputs and runs dfs_device.derive_rows (K6) or
n_device.derive_b_jobs (K9) on them: the kernel's time alone (CUDA events
around the launch, behind a spin kernel; median, min and max of --reps
calls, scripts/best_bench.py kernel_ms), the bytes the kernel must move
and their bound at chip_smoke.py's HBM rate, and ptxas's lines (stack
frame, spills, registers) for both kernels.  It writes NAME.json and, per
case, the outputs as NAME.CASE.npz under the work directory
(.scratch/jobsbench of the tree this script is in).  The second form holds
every NAME's outputs to the first NAME's, case by case, and prints each
case's times side by side; it raises on a difference.

Cases (inputs from --seed; the 4.6 Mbp genome with 64 copies of a 2 kb
segment and its index, scripts/k7_bench.py's, are built once into the
work directory; reads are k7_bench.py's copy of chip_smoke.py's mixes):
  k6_v1       the -v 1 job table of the CLI's batch, 8,192 reads, L 40
  k6_v2       the -v 2 job table of the same reads
  k6_nA       -n 2 launch A's table of 8,192 reads of the n mix
  k6_nB       -n 2 launch B's table, 8,192 x 36 rows, built by K9 from
              launch A's outputs on the card
  k6_long128  the -v 2 table of 8,192 reads of 100 bp with runs of Ns,
              L 128 (the N tally crosses 32-position chunks)
  k6_long256  the same with reads of 250 bp, L 256
  k9_8k       K9 on that launch A's outputs (-n 2, 8,192 lanes)
  k9_full_n1, k9_full_n2, k9_full_n3, k9_full_norc, k9_full_nofw
              K9 on 8,192 lanes that all take jobs, 32 partials each, at
              -n 1, 2, 3 and -n 2 with --norc and with --nofw
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(HERE, ".scratch", "jobsbench")
BATCH = 8192                  # the CLI's --batch-size default
HBM_BYTES_PER_S = 3.35e12     # chip_smoke.py's H100 SXM HBM3 rate
K6_CASES = ("k6_v1", "k6_v2", "k6_nA", "k6_nB", "k6_long128", "k6_long256")
K9_FULL = {"k9_full_n1": (1, False, False), "k9_full_n2": (2, False, False),
           "k9_full_n3": (3, False, False),
           "k9_full_norc": (2, True, False),
           "k9_full_nofw": (2, False, True)}
ALL_CASES = K6_CASES + ("k9_8k",) + tuple(K9_FULL)
MAXBTS = 125                  # -n's default backtrack ceiling
JRC = 3                       # launch A's rc partial-collection job


def _load(name, path):
    """A module of this script's own tree by path (it imports numpy
    only), whatever tree --root names."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


k7 = _load("jobsbench_k7_bench", os.path.join(HERE, "scripts",
                                              "k7_bench.py"))
bb = _load("jobsbench_best_bench", os.path.join(HERE, "scripts",
                                                "best_bench.py"))


# ---------------------------------------------------------------- inputs

def long_reads(rng, genome, n, length):
    """n reads of `length` bases: random genome positions, half reverse
    complemented, 0-3 mismatches, a run of 1-6 Ns in every fifth read
    and a scattered N in every seventh; Phred 2-40."""
    pos = rng.integers(0, len(genome) - length, n)
    codes = genome[pos[:, None] + np.arange(length)].copy()
    rc = rng.random(n) < 0.5
    codes[rc] = k7.COMP[codes[rc, ::-1]]
    rows = np.arange(n)
    for m in range(3):
        sel = rows % (m + 2) == 1
        col = rng.integers(0, length, n)
        codes[rows[sel], col[sel]] = (codes[rows[sel], col[sel]] + 1) % 4
    for b in range(0, n, 5):
        s = int(rng.integers(0, length - 6))
        codes[b, s:s + int(rng.integers(1, 7))] = 4
    sc = rows[::7]
    codes[sc, rng.integers(0, length, len(sc))] = 4
    return codes, rng.integers(2, 41, (n, length))


def k9_full_inputs(torch, B, L, seed, dev):
    """Launch-A outputs on which every lane takes jobs: result 0, no
    overflow, done, ungated, 32 partials each (job JRC or another), 0-3
    mutations at positions inside the read, codes 0-3; reads of 36 bases,
    Phred 2-40."""
    rng = np.random.default_rng(seed)
    P = 32
    plen = np.full(B, 36, np.int32)
    out_a = {"result": np.zeros(B, np.int32),
             "overflow": np.zeros(B, bool),
             "mode": np.zeros(B, np.int32),
             "npart": np.full(B, P, np.int32),
             "part_job": np.where(rng.random((B, P)) < 0.5, JRC,
                                  JRC + 1).astype(np.int32),
             "part_n": rng.integers(0, 4, (B, P)).astype(np.int32),
             "part_pos": rng.integers(0, 36, (B, 3 * P)).astype(np.int32),
             "part_refc": rng.integers(0, 4, (B, 3 * P)).astype(np.int32)}
    qual = rng.integers(2, 41, (B, L)).astype(np.int8)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return ({k: t(v) for k, v in out_a.items()}, t(np.zeros(B, bool)),
            t(qual), t(plen))


def make_inputs(T, args, dev):
    """{case: ("K6", (scal, codes, qual, plen, fc)) or ("K9", (args,
    kwargs))} for the cases asked for."""
    torch, D, N = T.torch, T.D, T.N
    cases, work = args.cases.split(","), args.work
    small = os.path.join(work, "g46")
    k7.ensure_index(T, small, 4_600_000, args.seed, False)
    genome, starts = k7.genome_of(4_600_000, args.seed)
    idx, idx_bw = T.read_ebwt(small), T.read_ebwt(small + ".rev")
    pair = D.build_fmpair(idx, idx_bw, dev, dense_sa=True)
    fc = pair.ftab_chars
    qr = torch.from_numpy(T.qual_rounds.astype(np.int32)).to(dev)
    out = {}

    def t(x, dt=None):
        x = np.ascontiguousarray(x if dt is None else x.astype(dt))
        return torch.from_numpy(x).to(dev)

    def v_table(reads, v, L):
        jobs, _ = T.v_jobs(reads, v, False, False, L)
        return ("K6", (t(np.stack([jobs[f] for f in D.JOB_FIELDS], -1),
                         np.int32), t(jobs["base_codes"], np.int8),
                       t(jobs["base_qual"], np.int8),
                       t(jobs["base_plen"], np.int32), fc))
    if {"k6_v1", "k6_v2"} & set(cases):
        reads = k7.reads_of(T, os.path.join(work, f"v.{args.tag}.fq"),
                            genome, starts, args.seed + 1, BATCH)
        for v in (1, 2):
            if f"k6_v{v}" in cases:
                out[f"k6_v{v}"] = v_table(reads, v, 40)
    if {"k6_nA", "k6_nB", "k9_8k"} & set(cases):
        nreads = k7.reads_of(T, os.path.join(work, f"n.{args.tag}.fq"),
                             genome, starts, args.seed + 2, BATCH,
                             nmix=True)
        jobs, _, gated, jrc, _ = T.n_jobs(nreads, 2, 28, 70, MAXBTS, True,
                                          False, False, 40)
        base = [t(jobs[k]) for k in ("base_codes", "base_qual",
                                     "base_plen")]
        scal_a = t(np.stack([jobs[f] for f in D.JOB_FIELDS], -1), np.int32)
        out["k6_nA"] = ("K6", (scal_a, *base, fc))
        seeds = torch.from_numpy(
            T.seeds_of(nreads, 0).astype(np.int64)).to(dev)
        out_a, _ = D.run_machine(
            pair, D.upload_jobs(jobs, fc, dev), seeds,
            torch.zeros(BATCH, dtype=torch.int32, device=dev),
            n_k=1, m_max=0x7FFFFFFF, max_steps=60000)
        kw = dict(J=N.J_B, jrc=jrc, n=2, s=28, qt=70, maxbts=MAXBTS,
                  maq=True, norc=False, nofw=False)
        bargs = (out_a, t(gated), base[1], base[2], qr)
        out["k9_8k"] = ("K9", (bargs, kw))
        out["k6_nB"] = ("K6", (N.derive_b_jobs(*bargs, **kw), *base, fc))
    for name, length, L in (("k6_long128", 100, 128),
                            ("k6_long256", 250, 256)):
        if name in cases:
            codes, quals = long_reads(np.random.default_rng(args.seed + L),
                                      genome, BATCH, length)
            path = os.path.join(work, f"{name}.{args.tag}.fq")
            k7.write_fastq(path, codes, np.full(BATCH, length), quals)
            out[name] = v_table(list(T.ReadSource([path]).records()), 2, L)
    for i, (name, (n, norc, nofw)) in enumerate(K9_FULL.items()):
        if name in cases:
            a, gated, qual, plen = k9_full_inputs(torch, BATCH, 40,
                                                  args.seed + 10 + i, dev)
            kw = dict(J=N.J_B, jrc=JRC, n=n, s=28, qt=70, maxbts=MAXBTS,
                      maq=True, norc=norc, nofw=nofw)
            out[name] = ("K9", ((a, gated, qual, plen, qr), kw))
    return out


# ---------------------------------------------------------------- bytes

def nbytes(*ts) -> int:
    return sum(x.numel() * x.element_size() for x in ts)


def k6_bytes(inp, res) -> int:
    """Each input read once, each output written once (chip_smoke.py
    dfs_case's nbytes6)."""
    return nbytes(*inp[:4], *res)


def k9_bytes(T, bargs, kw, res) -> int:
    """chip_smoke.py's k9_bytes: per lane result, mode, npart and plen
    (4 B each) and overflow and gated (1 B each); each partial row a
    taking lane counts (32 B) and the quality byte at each mutation; the
    1 KB Maq table; the whole [B, J, NJF] table written."""
    out_a, gated = bargs[0], bargs[1]
    torch = T.torch
    B = out_a["npart"].shape[0]
    active = ((out_a["result"] == 0) & ~out_a["overflow"]
              & (out_a["mode"] == 0) & ~gated & (kw["n"] > 0))
    slot = torch.arange(32, device=gated.device)[None, :]
    counted = (slot < out_a["npart"][:, None]) & active[:, None]
    return (18 * B + 32 * int(counted.sum())
            + int(out_a["part_n"][counted].sum()) + 4 * 256
            + 4 * res.numel())


# ---------------------------------------------------------------- worker

def worker(args) -> int:
    T = k7.Tree(args.root)
    torch, D, N = T.torch, T.D, T.N
    if not torch.cuda.is_available():
        print("jobs_bench: no CUDA device", file=sys.stderr)
        return 2
    kd = k7._kdiag()
    dev = torch.device("cuda")
    os.makedirs(args.work, exist_ok=True)
    t = time.time()
    T.kernels.lib()
    with open(os.path.join(T.root, "bowtie_tpu_torch", "csrc", "build",
                           "ptxas.txt")) as f:
        report = f.read()
    res = {"root": T.root, "tag": args.tag,
           "kernel_build_s": time.time() - t,
           "ptxas": {k: kd.ptxas_entry(report, k)
                     for k in ("derive_rows", "derive_b_jobs")},
           "cases": {}}
    if hasattr(D, "jobs_local_bytes"):
        res["local_bytes"] = D.jobs_local_bytes()
    inputs = make_inputs(T, args, dev)
    for name in args.cases.split(","):
        kind, inp = inputs[name]
        if kind == "K6":
            def call():
                return D.derive_rows(*inp)
            launch = "derive_rows"
        else:
            def call():
                return N.derive_b_jobs(*inp[0], **inp[1])
            launch = "derive_b_jobs"
        got = call()
        torch.cuda.synchronize()
        outs = got if kind == "K6" else (got,)
        np.savez(os.path.join(args.work, f"{args.tag}.{name}.npz"),
                 **{f"out{i}": o.cpu().numpy() for i, o in enumerate(outs)})
        if kind == "K6":
            scal = inp[0]
            b = k6_bytes(inp, outs)
            row = dict(kernel="K6", lanes=int(scal.shape[0]),
                       jobs=int(scal.shape[1]), L=int(inp[1].shape[1]),
                       rows=int(scal.shape[0] * scal.shape[1]))
            if hasattr(D, "derive_rows_shape"):
                row["shape"] = D.derive_rows_shape(*scal.shape[:2])
        else:
            b = k9_bytes(T, inp[0], inp[1], got)
            row = dict(kernel="K9", lanes=int(got.shape[0]),
                       jobs=int(got.shape[1]), n=inp[1]["n"],
                       norc=inp[1]["norc"], nofw=inp[1]["nofw"],
                       valid_jobs=int(got[..., 0].sum()))
            if hasattr(N, "derive_b_jobs_shape"):
                row["shape"] = N.derive_b_jobs_shape(*got.shape[:2])
        row.update(bytes=b, bound_ms=1e3 * b / HBM_BYTES_PER_S,
                   **bb.spread(bb.kernel_ms(T, call, args.reps, (launch,))))
        res["cases"][name] = row
        print(json.dumps({name: row}), flush=True)
    res["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    with open(os.path.join(args.work, f"{args.tag}.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps({"tag": args.tag, "ptxas": res["ptxas"],
                      "local_bytes": res.get("local_bytes"),
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
        c = runs[0]["cases"][name]
        table[name] = dict(bound_ms=c["bound_ms"], bytes=c["bytes"], **{
            r["tag"]: [r["cases"][name][k] for k in ("ms", "ms_min",
                                                      "ms_max")]
            for r in runs})
    print(json.dumps({"equal_outputs": True,
                      "ms_median_min_max": table,
                      "gpu": runs[0].get("gpu")}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--cases", default=",".join(ALL_CASES))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work", default=WORK)
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args()
    return compare(args) if args.compare else worker(args)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The best-first machine (csrc/best.cu best_machine_kernel: K10, K10r in
record mode, K14 in paired record mode) timed on seeded inputs, for one
source tree at a time, so that two trees can be compared on one card in
one sitting.

    python3 scripts/best_bench.py --root DIR --tag NAME [--cases a,b,...]
                                  [--reps N] [--diag]
    python3 scripts/best_bench.py --compare NAME NAME ...

The first form imports bowtie_tpu_torch from DIR (its kernels are built
there), builds each case's machine inputs as the CLI's aligner builds
them, and runs best_device.run_machine on them: the kernel's time alone
(CUDA events around the launch, behind a spin kernel; median, min and
max of --reps calls), the wrapper's time as chip_smoke.py takes it
(events around run_machine, which also packs and uploads the lanes'
state), the per-lane transitions summarised (utils/kdiag.py lane_stats:
max, p50, p99, mean, warp efficiency) and, with --diag, the slowest lane
alone, its warp's 32 lanes alone (as one block) and, for the 8,192-lane
cases, the batch launched as four 2,048-lane slices one after another.
It writes NAME.json and, per case, the outputs and per-lane transitions
as NAME.CASE.npz under the work directory (.scratch/bestbench of the
tree this script is in).  The second form holds every NAME's outputs, hit
rows and per-lane transitions to the first NAME's, case by case, and
prints each case's times side by side; it raises on a difference.

Cases (inputs from --seed; a 4.6 Mbp genome with 64 copies of a 2 kb
segment, and its index, are built once into the work directory, as
chip_smoke.py builds its own):
  k14_8k    K14 on the CLI's first --best batch: 8,192 pairs of 2 x 50 bp
            mates (chip_smoke.py's pe_pairs mix), -n 2 -k 1 --best --fr
            -X 250, the merged 12/28-driver DAG, rec_cap 8
  k14_2k    its first 2,048 pairs
  k14_n3    -n 3 --best, the 16/48-driver DAG, uncapped, 256 pairs
  k10_2k    K10 under -v 2 -k 3 --best --strata on 2,048 reads of
            chip_smoke.py's n mix (36 bp, three mismatches in every
            third read, Phred 2-40)
  k10_8k    K10 on the CLI's first batch of -v 2 -m 1 --best --strata
            (8,192 such reads)
  k10r_rc1  K10r on the default paired command's first batch (8,192
            pairs, -n 2 -k 1 --fr -X 250): the lanes phase 0 leaves, at
            rec_cap 1
  big_k10   k10_8k's policy on 8,192 reads of a seeded 100 Mbp genome
            (C. elegans' size; index built with the suffix array on the
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
WORK = os.path.join(HERE, ".scratch", "bestbench")
READ_LEN = 36
PE_LEN = 50
COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)
BATCH = 8192                  # the CLI's --batch-size default
SLICE = 2048
ALL_CASES = ("k14_8k", "k14_2k", "k14_n3", "k10_2k", "k10_8k", "k10r_rc1",
             "big_k10")
LAUNCH_NAMES = ("best_machine", "best_record", "best_pev2")


def _kdiag():
    """utils/kdiag.py of this script's own tree (it imports numpy only),
    whatever tree --root names."""
    spec = importlib.util.spec_from_file_location(
        "bestbench_kdiag",
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


def write_fastq(path, codes, lens, quals):
    with open(path, "wb") as f:
        for i, (row, ln) in enumerate(zip(codes, lens)):
            f.write(b"@r%d\n%s\n+\n%s\n" % (
                i, CHARS[row[:ln]].tobytes(),
                (quals[i, :ln] + 33).astype(np.uint8).tobytes()))


def n_mix_reads(rng, genome, starts, seg_len, n, path):
    """chip_smoke.py's n mix: 60 % exact, 10 % of the repeat, 10 % one
    mismatch, 5 % one N, 5 % cut to 5-9 bases, 10 % random; a second
    mismatch in every fourth read, three in every third; Phred 2-40."""
    L = READ_LEN
    kind = rng.choice(6, size=n, p=(0.60, 0.10, 0.10, 0.05, 0.05, 0.10))
    pos = rng.integers(0, len(genome) - L, n)
    rep = kind == 1
    pos[rep] = (starts[rng.integers(0, len(starts), rep.sum())]
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
    r3 = np.arange(0, n, 3)
    c3 = np.argsort(rng.random((len(r3), L)), 1)[:, :3]
    c = codes[r3[:, None], c3]
    codes[r3[:, None], c3] = np.where(
        c < 4, (c + rng.integers(1, 4, c.shape)) % 4, c)
    write_fastq(path, codes, lens, rng.integers(2, 41, (n, L)))


def pe_mix_pairs(rng, genome, starts, seg_len, n, path1, path2):
    """chip_smoke.py's pe_pairs mix: 2 x 50 bp --fr mates of fragments of
    100-250 bases (5 % 400-600), from either strand, 10 % starting in a
    repeat copy, 10 % of pairs with one random mate; each mate with the n
    mix's errors and Phred 2-40."""
    L = PE_LEN
    frag = rng.integers(100, 251, n)
    far = rng.random(n) < 0.05
    frag[far] = rng.integers(400, 601, int(far.sum()))
    start = rng.integers(0, len(genome) - 601, n)
    rep = rng.random(n) < 0.10
    start[rep] = (starts[rng.integers(0, len(starts), rep.sum())]
                  + rng.integers(0, seg_len - 600, rep.sum()))
    left = genome[start[:, None] + np.arange(L)]
    right = genome[(start + frag - L)[:, None] + np.arange(L)]
    flip = rng.integers(0, 2, n) == 1
    m1 = np.where(flip[:, None], COMP[right[:, ::-1]], left)
    m2 = np.where(flip[:, None], left, COMP[right[:, ::-1]])
    codes = np.concatenate([m1, m2])
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
    quals = rng.integers(2, 41, (m, L))
    for path, half in ((path1, 0), (path2, 1)):
        with open(path, "wb") as f:
            for i in range(n):
                j = half * n + i
                ln = lens[j]
                f.write(b"@p%d/%d\n%s\n+\n%s\n" % (
                    i, half + 1, CHARS[codes[j, :ln]].tobytes(),
                    (quals[j, :ln] + 33).astype(np.uint8).tobytes()))


# ---------------------------------------------------------------- worker

class Tree:
    """The modules of the tree under test."""

    def __init__(self, root):
        sys.path.insert(0, os.path.abspath(root))
        import torch
        from bowtie_tpu_torch import kernels
        from bowtie_tpu_torch.align import best_device, pe_device, pev2_device
        from bowtie_tpu_torch.align.policy import INF, KPolicy
        from bowtie_tpu_torch.build import sa
        from bowtie_tpu_torch.build.builder import build_index
        from bowtie_tpu_torch.cli import align as cli
        from bowtie_tpu_torch.io.readers import PairedReadSource, ReadSource
        from bowtie_tpu_torch.utils.rng import fill_seed_caches
        self.torch, self.kernels, self.bd = torch, kernels, best_device
        self.mods = (best_device, pe_device, pev2_device)
        self.INF, self.KPolicy, self.cli = INF, KPolicy, cli
        self.sa, self.build_index = sa, build_index
        self.PairedReadSource, self.ReadSource = PairedReadSource, ReadSource
        self.seeds_of = fill_seed_caches
        self.root = os.path.abspath(root)

    def aligner(self, argv, dev):
        """The aligner the CLI builds for argv (its index, reads and
        output given), with the CLI's policy."""
        cli = self.cli
        args = cli.build_parser().parse_args(argv)
        args.hits, args.reads = args.reads, args.ebwt_base
        args.ebwt_base = args.index_opt
        mhits = args.mhits if args.mhits is not None else self.INF
        policy = self.KPolicy(khits=self.INF if args.all else args.khits,
                              mhits=mhits)
        args.ebwt_base = cli.adjust_ebwt_base(args.ebwt_base)
        idx = cli.read_ebwt_cached(args.ebwt_base)
        if args.offrate > idx.off_rate:
            idx = idx.with_off_rate(args.offrate)
        return cli.build_aligner(args, idx, policy, dev)

    def capture(self, fn):
        """The (args, kwargs) of the first run_machine call fn makes."""
        bd = self.bd
        real, got = bd.run_machine, []

        def cap(*a, **k):
            got.append((a, k))
            return real(*a, **k)
        for m in self.mods:
            m.run_machine = cap
        try:
            fn()
        finally:
            for m in self.mods:
                m.run_machine = real
        return got[0]

    def run(self, args, kw):
        """run_machine's outputs and its per-lane transitions.  A tree
        whose wrapper returns only their maximum has its per-lane tensor
        caught where the wrapper allocates it."""
        bd, torch = self.bd, self.torch
        if hasattr(bd, "run_machine_lanes"):
            return bd.run_machine_lanes(*args, **kw)
        made = []

        class Catch:
            def __getattr__(self, k):
                return getattr(torch, k)

            def empty(self, *a, **k):
                t = torch.empty(*a, **k)
                made.append(t)
                return t
        bd.torch = Catch()
        try:
            out, _ = bd.run_machine(*args, **kw)
        finally:
            bd.torch = torch
        return out, made[len(bd.OUT_KEYS)]


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


def sub(args, kw, lo, hi):
    """The machine inputs of lanes [lo, hi)."""
    pair, cfg, host, seeds = args
    B = seeds.shape[0]
    h = {k: (v[lo:hi] if isinstance(v, np.ndarray) and v.ndim
             and v.shape[0] == B else v) for k, v in host.items()}
    return (pair, cfg, h, seeds[lo:hi].contiguous()), kw


def kernel_ms(T, call, reps, names=LAUNCH_NAMES):
    """The machine's launches alone (those counted under `names`): CUDA
    events recorded around each C entry's call (kernels.launch), behind a
    spin kernel, so the wrapper's packing and uploads stay outside.  ->
    ms per call (summed over its launches), reps calls after two warm-up
    calls."""
    torch, K = T.torch, T.kernels
    real, times = K.launch, []

    def timed(name, *a, **k):
        if name not in names:
            return real(name, *a, **k)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        s.record()
        real(name, *a, **k)
        e.record()
        times[-1].append((s, e))
    K.launch = timed
    try:
        for _ in range(2 + reps):
            times.append([])
            call()
            torch.cuda.synchronize()
    finally:
        K.launch = real
    return [sum(s.elapsed_time(e) for s, e in ev) for ev in times[2:]]


def call_ms(T, call, reps):
    """A wrapper's call (run_machine, run_ilv) as chip_smoke.py times it: events around the call,
    behind a ~0.5 ms spin kernel."""
    torch = T.torch
    call()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        s.record()
        call()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def spread(ts):
    return dict(ms=statistics.median(ts), ms_min=min(ts), ms_max=max(ts))


def make_inputs(T, args, dev):
    """{case: (run_machine args, kwargs)} for the cases asked for."""
    cases = args.cases.split(",")
    work = args.work
    small = os.path.join(work, "g46")
    ensure_index(T, small, 4_600_000, args.seed, False)
    genome, starts = genome_of(4_600_000, args.seed)
    inputs = {}
    if any(c.startswith(("k14", "k10r")) for c in cases):
        m1 = os.path.join(work, f"pe1.{args.tag}.fq")
        m2 = os.path.join(work, f"pe2.{args.tag}.fq")
        pe_mix_pairs(np.random.default_rng(args.seed + 1), genome, starts,
                     2000, BATCH, m1, m2)
        pairs = list(T.PairedReadSource([m1], [m2]).pairs())
        io = ["-x", small, "-1", m1, "-2", m2, os.path.join(work, "o")]
        for name, argv, n in (("k14_8k", ["--best"], BATCH),
                              ("k14_2k", ["--best"], SLICE),
                              ("k14_n3", ["-n", "3", "--best"], 256)):
            if name not in cases:
                continue
            al = T.aligner(argv + io, dev)
            ps = pairs[:n]
            s1 = T.seeds_of([p[0] for p in ps], al.global_seed)
            s2 = T.seeds_of([p[1] for p in ps], al.global_seed)
            a = al.machine.record_inputs(ps, s1, s2)
            # -n 3 as chip_smoke.py's pev2 phase runs it: uncapped
            cap = None if name == "k14_n3" else al.rec_cap
            inputs[name] = (a["args"], dict(a["kw"], rec_cap=cap))
        if "k10r_rc1" in cases:
            al = T.aligner(io, dev)
            a = al.record_inputs(pairs, 1)
            inputs["k10r_rc1"] = (a["args"], dict(a["kw"], rec_cap=1))
    se = [c for c in ("k10_2k", "k10_8k") if c in cases]
    if se:
        path = os.path.join(work, f"se.{args.tag}.fq")
        n_mix_reads(np.random.default_rng(args.seed + 2), genome, starts,
                    2000, BATCH, path)
        reads = list(T.ReadSource([path]).records())
        for name, argv, n in (
                ("k10_2k", ["-v", "2", "-k", "3", "--best", "--strata"],
                 SLICE),
                ("k10_8k", ["-v", "2", "-m", "1", "--best", "--strata"],
                 BATCH)):
            if name in se:
                al = T.aligner(argv + ["-x", small, path,
                                       os.path.join(work, "o")], dev)
                inputs[name] = T.capture(lambda: al.align_batch(reads[:n]))
    if "big_k10" in cases:
        big = os.path.join(work, "g100")
        ensure_index(T, big, 100_000_000, args.seed + 5, True)
        bgen, bstarts = genome_of(100_000_000, args.seed + 5)
        path = os.path.join(work, f"big.{args.tag}.fq")
        n_mix_reads(np.random.default_rng(args.seed + 3), bgen, bstarts,
                    2000, BATCH, path)
        reads = list(T.ReadSource([path]).records())
        al = T.aligner(["-v", "2", "-m", "1", "--best", "--strata", "-x",
                        big, path, os.path.join(work, "o")], dev)
        inputs["big_k10"] = T.capture(lambda: al.align_batch(reads))
        pair = inputs["big_k10"][0][0]
        inputs["big_k10"][1]["_rank_bytes"] = sum(
            t.numel() * t.element_size() for fm in (pair.fw, pair.bw)
            for t in (fm.bwt, fm.occ))
    return inputs


def worker(args) -> int:
    T = Tree(args.root)
    torch, bd = T.torch, T.bd
    if not torch.cuda.is_available():
        print("best_bench: no CUDA device", file=sys.stderr)
        return 2
    kd = _kdiag()
    dev = torch.device("cuda")
    os.makedirs(args.work, exist_ok=True)
    t = time.time()
    T.kernels.lib()
    with open(os.path.join(T.root, "bowtie_tpu_torch", "csrc", "build",
                           "ptxas.txt")) as f:
        report = kd.ptxas_entry(f.read(), "best_machine")
    res = {"root": T.root, "tag": args.tag,
           "kernel_build_s": time.time() - t, "ptxas": report,
           "local_bytes": bd.machine_local_bytes(), "cases": {}}
    if hasattr(bd, "machine_shape"):
        res["shape"] = {}
    inputs = make_inputs(T, args, dev)
    for name in args.cases.split(","):
        margs, kw = inputs[name]
        kw = dict(kw)
        rank_bytes = kw.pop("_rank_bytes", None)
        out, steps = T.run(margs, kw)
        torch.cuda.synchronize()
        st = steps.cpu().numpy()
        np.savez(os.path.join(args.work, f"{args.tag}.{name}.npz"),
                 steps=st, **{k: out[k].cpu().numpy() for k in bd.OUT_KEYS})
        B = int(margs[3].numel())
        row = dict(lanes=B, L=kw["L"], nd=kw["nd"], ndt=kw["ndt"],
                   record=bool(kw.get("record")),
                   paired=bool(kw.get("paired")),
                   rec_cap=kw.get("rec_cap"), max_steps=kw["max_steps"],
                   overflow_lanes=int(out["overflow"].sum()),
                   nhits=int(out["nhits"].sum()),
                   **spread(kernel_ms(T, lambda: T.run(margs, kw),
                                      args.reps)),
                   call=spread(call_ms(
                       T, lambda: bd.run_machine(*margs, **kw), 5)),
                   lanes_stats=kd.lane_stats(st))
        if rank_bytes:
            row["rank_bytes"] = rank_bytes
        if "shape" in res:
            res["shape"][name] = bd.machine_shape(
                B, kw["L"], kw["nd"], kw["ndt"], bool(kw.get("paired")))
        if args.diag:
            ls = row["lanes_stats"]
            b, w = ls["slowest_lane"], ls["slowest_warp"]
            one = sub(margs, kw, b, b + 1)
            row["slowest_lane_ms"] = statistics.median(kernel_ms(
                T, lambda: T.run(*one), 5))
            ww = sub(margs, kw, w, min(w + 32, B))
            # its warp's lanes as one block (a tree whose launch shape
            # spreads few lanes over the SMs is told the card has one)
            sms = getattr(bd, "SMS", None)
            if sms:
                bd.SMS = 1
            try:
                row["slowest_warp_ms"] = statistics.median(kernel_ms(
                    T, lambda: T.run(*ww), 5))
            finally:
                if sms:
                    bd.SMS = sms
            if B >= 2 * SLICE:
                parts = [sub(margs, kw, lo, min(lo + SLICE, B))
                         for lo in range(0, B, SLICE)]

                def slices():
                    for p in parts:
                        T.run(*p)
                row["slices"] = dict(n=len(parts), lanes=SLICE,
                                     **spread(kernel_ms(T, slices, 5)))
        res["cases"][name] = row
        print(json.dumps({name: row}), flush=True)
    res["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    with open(os.path.join(args.work, f"{args.tag}.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps({"tag": args.tag, "ptxas": res["ptxas"],
                      "local_bytes": res["local_bytes"],
                      "shape": res.get("shape"), "gpu": res["gpu"]}),
          flush=True)
    return 0


def check_equal(work, tags, cases) -> None:
    """Raise unless each case's saved arrays (TAG.CASE.npz under work)
    are the same arrays with the same values under every tag as under
    the first."""
    first = tags[0]
    for name in cases:
        ref = np.load(os.path.join(work, f"{first}.{name}.npz"))
        for t in tags[1:]:
            got = np.load(os.path.join(work, f"{t}.{name}.npz"))
            if sorted(got.files) != sorted(ref.files):
                raise SystemExit(f"{name}: {t} has other outputs than "
                                 f"{first}")
            for k in ref.files:
                if not np.array_equal(ref[k], got[k]):
                    raise SystemExit(f"{name}: {t} differs from {first} "
                                     f"in {k}")


def compare(args) -> int:
    runs = [json.load(open(os.path.join(args.work, f"{t}.json")))
            for t in args.compare]
    check_equal(args.work, args.compare, runs[0]["cases"])
    table = {name: {r["tag"]: [r["cases"][name][k] for k in
                               ("ms", "ms_min", "ms_max")] for r in runs}
             for name in runs[0]["cases"]}
    print(json.dumps({"equal_outputs_hits_and_steps": True,
                      "kernel_ms_median_min_max": table,
                      "gpu": runs[0].get("gpu")}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--cases", default=",".join(ALL_CASES))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--diag", action="store_true")
    ap.add_argument("--work", default=WORK)
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args()
    return compare(args) if args.compare else worker(args)


if __name__ == "__main__":
    sys.exit(main())

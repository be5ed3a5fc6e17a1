#!/usr/bin/env python3
"""K3's walk-left (resolve_rows on an index without a dense SA) and K4
(one_row, the fused exact search, row pick and walk) timed on the rows
and strands the CLI gives them, for one source tree at a time, so that
two trees can be compared on one card in one sitting.

    python3 scripts/walk_bench.py --root DIR --tag NAME [--cases a,b,...]
                                  [--reps N]
    python3 scripts/walk_bench.py --compare NAME NAME ...

The first form imports bowtie_tpu_torch from DIR (its kernels are built
there), builds each case's inputs and runs exact.resolve_rows (K3 walk)
or pipeline.one_row (K4) on them.  For each case it records: the
kernel's time alone (CUDA events around the launch, behind a spin
kernel; median, min and max of --reps calls, scripts/best_bench.py
kernel_ms), the outputs held to the plain version's on the card, the
bound and sector ms of chip_smoke.py's model (utils/yardstick.py) for
what the tree's walk step reads (its walk table's one sector, or in a
tree without one an occ row and a word block), the walk steps and the
longest walk (K4: the longest chain of LF and walk steps) counted by the
plain version, the warp efficiency of one row (strand) a thread
(utils/kdiag.py lane_stats over the steps in launch order), and the
chain floor: the kernel launched on the one row (K3) or strand (K4) with
the longest chain, alone.  Where the tree's K3 reports its warps'
iterations (exact.resolve_rows_lanes), the warp efficiency of its own
schedule too: row steps over lane slots x iterations.  It writes
NAME.json and, per case, the outputs as NAME.CASE.npz under the work
directory (.scratch/walkbench of the tree this script is in).  The
second form holds every NAME's outputs to the first NAME's byte for
byte, on each case the first NAME ran, and prints the times, bounds and
chain floors side by side; it raises on a difference.

Cases (inputs from --seed; the 4.6 Mbp genome with 64 copies of a 2 kb
segment and its offRate-5 index are scripts/k7_bench.py's, which are
chip_smoke.py's and scripts/profile_torch_cli.py's; reads are
chip_smoke.py's make_reads mix, utils/yardstick.py):
  k3_cli      the rows of K3's one launch in the CLI's -v 0 -a -m 3 -S
              (--batch-size 65536): 50,000 reads, their ranges' rows in
              the chase order of ExactAligner._align_batch_enum
  k3_kernels  chip_smoke.py phase kernels' rows: K2's top rows of 2^20
              reads (2^21 strands) where the range is not empty
  k3_big      k3_cli's mix on a seeded 100 Mbp genome (index built with
              the suffix array on the card, past the 50 MB L2): the
              rows of its first reads, cut at 2^23 rows
  k3_norep    2^20 reads of the mix without its repeat and short reads,
              on a 4.6 Mbp genome without the repeat: one or two rows a
              read
  k3_thin     k3_kernels' first 65,536 rows on the index with its SA
              sample thinned to offRate 13 (chip_smoke.py phase
              kernels): most walks pass MAX_WALK
  k4_cli      K4 on one CLI batch: 8,192 reads, 16,384 strands
  k4_2m       K4 on phase kernels' 2^21 strands
  k4_thin     K4 on their first 65,536 strands, thinned index
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(HERE, ".scratch", "walkbench")
SEG = 2000
SMALL_BP = 4_600_000
BIG_BP = 100_000_000
CLI_READS = 50_000
CLI_BATCH = 8192               # the CLI's --batch-size default
BIG_ROWS = 1 << 23
THIN_ROWS = 1 << 16
ALL_CASES = ("k3_cli", "k3_kernels", "k3_big", "k3_norep", "k3_thin",
             "k4_cli", "k4_2m", "k4_thin")
# the shares of the read kinds (yardstick.KINDS) without the repeat and
# short reads
NOREP_P = tuple(p / 0.85 for p in (0.60, 0.0, 0.10, 0.05, 0.0, 0.10))


def _load(name, path):
    """A module of this script's own tree by path (it imports numpy
    only), whatever tree --root names."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


k7 = _load("walkbench_k7_bench", os.path.join(HERE, "scripts",
                                              "k7_bench.py"))
bb = _load("walkbench_best_bench", os.path.join(HERE, "scripts",
                                                "best_bench.py"))
kd = k7._kdiag()
# the bound model and read mix of chip_smoke.py
ys = _load("walkbench_yardstick", os.path.join(
    HERE, "bowtie_tpu_torch", "utils", "yardstick.py"))


class Tree:
    """The modules of the tree under test."""

    def __init__(self, root):
        sys.path.insert(0, os.path.abspath(root))
        import torch
        from bowtie_tpu_torch import kernels
        from bowtie_tpu_torch.align import exact, pipeline
        from bowtie_tpu_torch.build import sa
        from bowtie_tpu_torch.build.builder import build_index
        from bowtie_tpu_torch.index.arrays import from_ebwt
        from bowtie_tpu_torch.index.ebwt_io import read_ebwt
        from bowtie_tpu_torch.io.readers import ReadSource
        from bowtie_tpu_torch.utils.rng import fill_seed_caches, next_u32
        self.torch, self.kernels, self.E, self.P = (torch, kernels, exact,
                                                     pipeline)
        self.sa, self.build_index, self.read_ebwt = sa, build_index, read_ebwt
        self.from_ebwt, self.ReadSource = from_ebwt, ReadSource
        self.seeds_of, self.next_u32 = fill_seed_caches, next_u32
        self.root = os.path.abspath(root)


# ---------------------------------------------------------------- inputs

def enum_rows(T, fm, path, limit=None):
    """Every row of every read's ranges in the chase order of
    ExactAligner._align_batch_enum (align/pipeline.py), for the reads of
    FASTQ `path` in one batch: K2 on the card, then the per-strand start
    top + rand % spread and the wrap; cut after the strand that passes
    `limit` rows."""
    torch, E = T.torch, T.E
    reads = list(T.ReadSource([path]).records())
    B = len(reads)
    mat, lens = E.right_align([r.codes_fw for r in reads]
                              + [r.codes_rc for r in reads])
    dev = fm.device
    top, bot = (x.cpu().numpy() for x in E.exact_ranges(
        fm, torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev)))
    spread = bot - top
    _, rand1 = T.next_u32(T.seeds_of(reads, 0))
    lane = np.arange(2 * B).reshape(2, B).T.reshape(-1)
    lane = lane[spread[lane] > 0]
    sp = spread[lane]
    if limit is not None:
        keep = int(np.searchsorted(np.cumsum(sp), limit)) + 1
        lane, sp = lane[:keep], sp[:keep]
    r0 = rand1[lane % B].astype(np.int64) % sp
    k = (np.arange(int(sp.sum()), dtype=np.int64)
         - np.repeat(np.cumsum(sp) - sp, sp))
    rows = (np.repeat(top[lane], sp)
            + (np.repeat(r0, sp) + k) % np.repeat(sp, sp))
    return torch.from_numpy(rows).to(dev)


def thinned(fm):
    """fm with every 256th SA sample (offRate + 8), as chip_smoke.py
    phase kernels thins it."""
    return dataclasses.replace(fm, offs=fm.offs[::256].contiguous(),
                               off_rate=fm.off_rate + 8, kernel_view=None)


def make_inputs(T, args, dev):
    """{case: ("K3", fm, rows) or ("K4", fm, mat, lens, seeds)}."""
    torch = T.torch
    cases, work, seed = args.cases.split(","), args.work, args.seed
    out = {}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    small = os.path.join(work, "g46")
    k7.ensure_index(T, small, SMALL_BP, seed, False)
    fm = T.from_ebwt(T.read_ebwt(small), device=dev)
    if {"k3_cli"} & set(cases):
        rng = np.random.default_rng(seed)
        genome, starts = k7.make_genome(rng, SMALL_BP, 64, SEG)
        codes, lens = ys.make_reads(rng, genome, starts, SEG, CLI_READS)[:2]
        path = os.path.join(work, f"cli.{args.tag}.fq")
        k7.write_fastq(path, codes, lens)
        out["k3_cli"] = ("K3", fm, enum_rows(T, fm, path))
    if {"k3_kernels", "k3_thin", "k4_2m", "k4_thin"} & set(cases):
        rng = np.random.default_rng(seed)      # phase kernels' inputs
        genome, starts = k7.make_genome(rng, SMALL_BP, 64, SEG)
        codes, lens = ys.make_reads(rng, genome, starts, SEG, 1 << 20)[:2]
        mat_np, lens_np = ys.strand_matrix(codes, lens)
        mat, lens2 = t(mat_np), t(lens_np)
        seeds = t(rng.integers(0, 2**32, len(lens_np),
                               dtype=np.uint64).astype(np.int64))
        top, bot = T.E.exact_ranges(fm, mat, lens2)
        rows = top[bot > top].contiguous()
        thin = thinned(fm)
        out["k3_kernels"] = ("K3", fm, rows)
        out["k3_thin"] = ("K3", thin, rows[:THIN_ROWS].contiguous())
        out["k4_2m"] = ("K4", fm, mat, lens2, seeds)
        out["k4_thin"] = ("K4", thin, *(x[:THIN_ROWS].contiguous()
                                        for x in (mat, lens2, seeds)))
    if "k4_cli" in cases:
        rng = np.random.default_rng(seed + 5)
        genome, starts = k7.genome_of(SMALL_BP, seed)
        codes, lens = ys.make_reads(rng, genome, starts, SEG, CLI_BATCH)[:2]
        mat_np, lens_np = ys.strand_matrix(codes, lens)
        out["k4_cli"] = ("K4", fm, t(mat_np), t(lens_np),
                         t(rng.integers(0, 2**32, len(lens_np),
                                        dtype=np.uint64).astype(np.int64)))
    if "k3_norep" in cases:
        base = os.path.join(work, "norep")
        rng = np.random.default_rng(seed + 6)
        genome = rng.integers(0, 4, SMALL_BP).astype(np.uint8)
        if not os.path.exists(base + ".rev.2.ebwt"):
            T.build_index([genome], ["synthetic_4.6M no repeat"], base,
                          off_rate=5, ftab_chars=10)
        nfm = T.from_ebwt(T.read_ebwt(base), device=dev)
        codes, lens = ys.make_reads(rng, genome, np.zeros(1, np.int64),
                                    SEG, 1 << 20, NOREP_P)[:2]
        path = os.path.join(work, f"norep.{args.tag}.fq")
        k7.write_fastq(path, codes, lens)
        out["k3_norep"] = ("K3", nfm, enum_rows(T, nfm, path))
    if "k3_big" in cases:
        big = os.path.join(work, "g100")
        k7.ensure_index(T, big, BIG_BP, seed, True)
        bfm = T.from_ebwt(T.read_ebwt(big), device=dev)
        rng = np.random.default_rng(seed)
        genome, starts = k7.make_genome(rng, BIG_BP, 64, SEG)
        codes, lens = ys.make_reads(rng, genome, starts, SEG, CLI_READS)[:2]
        path = os.path.join(work, f"big.{args.tag}.fq")
        k7.write_fastq(path, codes, lens)
        out["k3_big"] = ("K3", bfm, enum_rows(T, bfm, path, BIG_ROWS))
    return {c: out[c] for c in cases}


# ---------------------------------------------------------------- bounds

def nbytes(*ts) -> int:
    return sum(x.numel() * x.element_size() for x in ts)


def walk_reads(T, fm):
    """What the tree's walk steps read besides bwt and occ, and the
    sectors a step: ([its walk table], 1) where it has one (fm.cuh
    lf_walk), else ([], 2): an occ row and a word block, as an LF step
    (lf_row)."""
    if hasattr(T.E, "walk_table"):
        return [T.E.walk_table(fm)], ys.SECTORS_PER_WALK_STEP
    return [], ys.SECTORS_PER_LF_STEP


# ---------------------------------------------------------------- worker

def k3_case(T, fm, rows, reps):
    torch, E = T.torch, T.E
    m = rows.numel()
    off, ok = E.resolve_rows(fm, rows)
    walk = torch.zeros(2, m, dtype=torch.int64, device=rows.device)
    poff, pok = E.resolve_rows_plain(fm, rows, walk)
    torch.cuda.synchronize()
    if not (torch.equal(off, poff) and torch.equal(ok, pok)):
        raise SystemExit("K3 walk differs from its plain version")
    steps = walk[0].cpu().numpy()
    total, words = int(steps.sum()), int(walk[1].sum())
    arrays, per_step = walk_reads(T, fm)
    row = dict(kernel="K3 walk", rows=m, walk_steps=total,
               max_walk=int(steps.max()), not_ok=int((~ok).sum()),
               one_row_a_thread=kd.lane_stats(steps),
               **ys.bounds(nbytes(*(arrays or [fm.bwt, fm.occ]), fm.offs,
                                  rows) + 9 * m, total, total, words,
                           per_step * total + m))
    del row["one_row_a_thread"]["histogram"]
    if hasattr(E, "resolve_rows_lanes"):
        _, _, iters = E.resolve_rows_lanes(fm, rows)
        shape = E.walk_shape(m)
        slots = 32 * int(iters.sum())
        row["own_schedule"] = dict(
            shape=shape, warp_iterations=int(iters.sum()),
            longest_warp=int(iters.max()),
            warp_efficiency=total / max(1, slots))
    name = ("resolve_rows_walk",)
    row.update(bb.spread(bb.kernel_ms(T, lambda: E.resolve_rows(fm, rows),
                                      reps, name)))
    j = int(steps.argmax())
    one = rows[j:j + 1].contiguous()
    row["chain_floor"] = bb.spread(bb.kernel_ms(
        T, lambda: E.resolve_rows(fm, one), reps, name))
    return row, {"off": off, "ok": ok}


def k4_case(T, fm, mat, lens, seeds, reps):
    torch, E, P = T.torch, T.E, T.P
    n = mat.shape[0]
    res = P.one_row(fm, mat, lens, seeds)
    work = torch.zeros(2, n, dtype=torch.int64, device=mat.device)
    pres = P.one_row_plain(fm, mat, lens, seeds, work)
    k2 = torch.zeros(2, n, dtype=torch.int64, device=mat.device)
    E.exact_ranges_plain(fm, mat, lens, k2)
    torch.cuda.synchronize()
    if not torch.equal(res, pres):
        raise SystemExit("K4 differs from its plain version")
    lf, chain = int(k2[0].sum()), work[0].cpu().numpy()
    walk = int(chain.sum()) - lf
    n_ftab = int((lens >= fm.ftab_chars).sum())
    arrays, per_step = walk_reads(T, fm)
    row = dict(kernel="K4", strands=n, lf_steps=lf, walk_steps=walk,
               max_chain=int(chain.max()),
               hits=int((res[0] > 0).sum()),
               not_ok=int(((res[0] > 0) & (res[2] == 0)).sum()),
               one_strand_a_thread=kd.lane_stats(chain),
               **ys.bounds(nbytes(fm.bwt, fm.occ, *arrays, fm.ftab_hi,
                                  fm.ftab_lo, fm.offs, mat, lens, seeds)
                           + 24 * n,
                           2 * lf + walk, walk, int(work[1].sum()),
                           2 * n_ftab + 2 * ys.SECTORS_PER_LF_STEP * lf
                           + per_step * walk + n))
    del row["one_strand_a_thread"]["histogram"]
    name = ("one_row",)
    row.update(bb.spread(bb.kernel_ms(
        T, lambda: P.one_row(fm, mat, lens, seeds), reps, name)))
    j = int(chain.argmax())
    one = [x[j:j + 1].contiguous() for x in (mat, lens, seeds)]
    row["chain_floor"] = bb.spread(bb.kernel_ms(
        T, lambda: P.one_row(fm, *one), reps, name))
    row["ms_over_chain_floor"] = row["ms"] / row["chain_floor"]["ms"]
    return row, {"res": res}


def worker(args) -> int:
    T = Tree(args.root)
    torch = T.torch
    if not torch.cuda.is_available():
        print("walk_bench: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    os.makedirs(args.work, exist_ok=True)
    t = time.time()
    T.kernels.lib()
    with open(os.path.join(T.root, "bowtie_tpu_torch", "csrc", "build",
                           "ptxas.txt")) as f:
        report = f.read()
    res = {"root": T.root, "tag": args.tag,
           "kernel_build_s": time.time() - t,
           "ptxas": {k: kd.ptxas_entry(report, k) for k in (
               "resolve_kernel", "walk_kernel", "one_row_kernel",
               "walk_table_kernel")},
           "gpu": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "cases": {}}
    t = time.time()
    inputs = make_inputs(T, args, dev)
    res["inputs_s"] = time.time() - t
    for name, (kind, *inp) in inputs.items():
        row, outs = (k3_case if kind == "K3" else k4_case)(T, *inp,
                                                         args.reps)
        np.savez(os.path.join(args.work, f"{args.tag}.{name}.npz"),
                 **{k: v.cpu().numpy() for k, v in outs.items()})
        res["cases"][name] = row
        print(json.dumps({name: row}), flush=True)
    with open(os.path.join(args.work, f"{args.tag}.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps({k: res[k] for k in ("tag", "ptxas", "gpu",
                                          "kernel_build_s", "inputs_s")}),
          flush=True)
    return 0


def compare(args) -> int:
    runs = [json.load(open(os.path.join(args.work, f"{t}.json")))
            for t in args.compare]
    first = args.compare[0]
    table = {}
    for name in runs[0]["cases"]:
        ref = np.load(os.path.join(args.work, f"{first}.{name}.npz"))
        have = [r for r in runs if name in r["cases"]]
        for r in have:
            got = np.load(os.path.join(args.work, f"{r['tag']}.{name}.npz"))
            for k in ref.files:
                if not np.array_equal(ref[k], got[k]):
                    raise SystemExit(f"{name}: {r['tag']} differs from "
                                     f"{first} in {k}")
        table[name] = {r["tag"]: {k: r["cases"][name][k] for k in (
            "ms", "bound_ms", "bound_by", "sector_ms")} | {
                "chain_floor": r["cases"][name]["chain_floor"]["ms"]}
            for r in have}
    print(json.dumps({"equal_outputs": True, "by_case_and_tree": table,
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

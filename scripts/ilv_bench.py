#!/usr/bin/env python3
"""K13 (the V1 interleave, chase and rescue machine, csrc/ilv.cu
ilv_kernel) timed on the paired CLI's own inputs, for one source tree at
a time, so that two trees can be compared on one card in one sitting.

    python3 scripts/ilv_bench.py --root DIR --tag NAME [--cases a,b,...]
                                 [--reps N] [--diag]
    python3 scripts/ilv_bench.py --compare NAME NAME ...

The first form imports bowtie_tpu_torch from DIR (its kernels are built
there), builds each case's K13 inputs as chip_smoke.py's k13_case does
(round 1's streams, recorded at rec_cap 1 after phase 0 by the CLI's own
aligner, then ilv_inputs) and runs pe_ilv_device.run_ilv on them: the
kernel's time alone (CUDA events around the launch, behind a spin
kernel; median, min and max of --reps calls), the wrapper's call (events
around run_ilv), the per-pair iterations summarised (utils/kdiag.py
lane_stats) and, with --diag, the slowest pair (most iterations) alone,
the 32 pairs from lane_stats' slowest_warp (under one thread a pair, the
warp that held the slowest pair; under a warp a pair, 32 warps) alone,
the eight pairs of most iterations each alone (the slowest of them), and
that pair's own work as run_ilv_plain counts it on that pair alone
(records popped, rows resolved, LF steps, scans, candidates, compared
bases, iterations).  It writes NAME.json and, per case, the outputs and per-pair
iterations as NAME.CASE.npz under the work directory (.scratch/ilvbench
of the tree this script is in).  The second form holds every NAME's
outputs and per-pair iterations to the first NAME's, case by case, and
prints each case's times side by side; it raises on a difference.

Cases (inputs from --seed; a 4.6 Mbp genome with 64 copies of a 2 kb
segment, and its index, are built once into the work directory, as
chip_smoke.py builds its own; the pairs are scripts/best_bench.py's
copy of chip_smoke.py's pe_pairs mix, 2 x 50 bp --fr mates):
  k13_8k    the default paired command's (-n 2 -k 1 --fr -X 250) first
            CLI batch, 8,192 pairs
  k13_512   its first 512 pairs (phase pe's count)
  k13_walk  its first 128 pairs on the pair thinned to offRate 13
            (walk-left: many pairs reach the 4,096-iteration budget)
  k13_wide  its first 512 pairs at -X 1000, whose rescue windows exceed
            K13's per-warp reference buffer, so they are staged in pieces
  big_k13   8,192 pairs of the same mix on a seeded 100 Mbp genome (C.
            elegans' size; index built with the suffix array on the
            card), past the 50 MB L2
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
WORK = os.path.join(HERE, ".scratch", "ilvbench")
BATCH = 8192                  # the CLI's --batch-size default
ALL_CASES = ("k13_8k", "k13_512", "k13_walk", "k13_wide", "big_k13")
# case -> (pairs, extra CLI flags, the pair thinned to offRate 13)
CASES = {"k13_8k": (BATCH, [], False), "k13_512": (512, [], False),
         "k13_walk": (128, [], True),
         "k13_wide": (512, ["-X", "1000"], False),
         "big_k13": (BATCH, [], False)}
WORK_KEYS = ("pops", "rows", "lf_steps", "scans", "candidates", "bases",
             "iterations")


def _load(name, path):
    """A module of this script's own tree by path (it imports numpy
    only), whatever tree --root names."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bb = _load("ilvbench_best_bench", os.path.join(HERE, "scripts",
                                               "best_bench.py"))


# ---------------------------------------------------------------- inputs

def k13_inputs(al, pairs):
    """K13's inputs for `pairs` as chip_smoke.py's k13_case builds them:
    round 1's streams at rec_cap 1 after phase 0, then ilv_inputs.  ->
    (S, the lane state)."""
    from bowtie_tpu_torch.utils.rng import fill_seed_caches
    idxs = list(range(len(pairs)))
    s1 = fill_seed_caches([p[0] for p in pairs], al.global_seed)
    sts, ovd = al._record_all(al.plan(pairs), idxs, s1, 1)
    items = [(i, sts[i]) for i in idxs if not ovd[i]]
    S, st, lanes, host = al.ilv_inputs(pairs, items, s1)
    if not lanes or host:
        raise RuntimeError(f"{len(lanes)} lanes, {len(host)} left to the "
                           "host replay")
    return S, st


def make_inputs(T, args, dev):
    """{case: (pair, S, lane state)} for the cases asked for."""
    from bowtie_tpu_torch.align.pe_device import DevicePairedBestAligner
    from bowtie_tpu_torch.align.policy import KPolicy
    from bowtie_tpu_torch.index.ebwt_io import (read_bitpair_reference,
                                                read_ebwt, unpack_reference)
    cases, work, out = args.cases.split(","), args.work, {}
    small = os.path.join(work, "g46")
    bb.ensure_index(T, small, 4_600_000, args.seed, False)
    genome, starts = bb.genome_of(4_600_000, args.seed)
    m1 = os.path.join(work, f"pe1.{args.tag}.fq")
    m2 = os.path.join(work, f"pe2.{args.tag}.fq")
    bb.pe_mix_pairs(np.random.default_rng(args.seed + 1), genome, starts,
                    2000, BATCH, m1, m2)
    pairs = list(T.PairedReadSource([m1], [m2]).pairs())
    io = ["-x", small, "-1", m1, "-2", m2, os.path.join(work, "o")]
    aligners = {}
    for name in cases:
        n, flags, thin = CASES[name]
        if name == "big_k13":
            continue
        if thin:
            idx = read_ebwt(small)
            refs = unpack_reference(*read_bitpair_reference(small),
                                    plen=idx.plen)
            idx_bw = read_ebwt(small + ".rev")
            al = DevicePairedBestAligner(
                idx.with_off_rate(idx.off_rate + 8),
                idx_bw.with_off_rate(idx_bw.off_rate + 8), refs, KPolicy(),
                compact=True, device=dev, mode="n", seed_mms=2)
        else:
            key = " ".join(flags)
            if key not in aligners:
                aligners[key] = T.aligner(flags + io, dev)
            al = aligners[key]
        out[name] = (al.pair, *k13_inputs(al, pairs[:n]))
    if "big_k13" in cases:
        big = os.path.join(work, "g100")
        bb.ensure_index(T, big, 100_000_000, args.seed + 5, True)
        bgen, bstarts = bb.genome_of(100_000_000, args.seed + 5)
        b1 = os.path.join(work, f"bpe1.{args.tag}.fq")
        b2 = os.path.join(work, f"bpe2.{args.tag}.fq")
        bb.pe_mix_pairs(np.random.default_rng(args.seed + 4), bgen, bstarts,
                        2000, BATCH, b1, b2)
        bpairs = list(T.PairedReadSource([b1], [b2]).pairs())
        al = T.aligner(["-x", big, "-1", b1, "-2", b2,
                        os.path.join(work, "o")], dev)
        out["big_k13"] = (al.pair, *k13_inputs(al, bpairs))
    return out


def sub_state(ilv, st, lo, hi):
    """init_state's lane state of pairs [lo, hi)."""
    s = {k: st[k][lo:hi].contiguous() for k in ilv.LANE_KEYS + ("rng",)}
    consts = {k: s[k] for k in ilv.LANE_KEYS[3:]}
    consts.update({k: st[k] for k in ilv.GLOBAL_KEYS})
    return ilv.init_state(hi - lo, s["hits"], s["nrec"], s["capped"],
                          s["rng"], consts)


# ---------------------------------------------------------------- timing

def diag(T, ilv, pair, S, st, it, kd):
    """The slowest pairs alone, and the slowest pair's own work."""
    B = it.shape[0]
    ls = kd.lane_stats(it)
    b, w = ls["slowest_lane"], ls["slowest_warp"]

    def alone(lo, hi):
        s = sub_state(ilv, st, lo, hi)
        return statistics.median(bb.kernel_ms(
            T, lambda: ilv.run_ilv(pair, s, S), 5, ("pe_ilv",)))
    top = [int(x) for x in np.argsort(-it, kind="stable")[:8]]
    each = {str(k): alone(k, k + 1) for k in top}
    work = {}
    ilv.run_ilv_plain(pair, sub_state(ilv, st, b, b + 1), S, work)
    return dict(slowest_pair=b, slowest_pair_ms=each[str(b)],
                slowest_32_pairs_ms=alone(w, min(w + 32, B)),
                top8_alone_ms=each,
                slowest_of_top8=max(each, key=each.get),
                slowest_pair_work={k: int(work[k]) for k in WORK_KEYS})


# ---------------------------------------------------------------- worker

def worker(args) -> int:
    T = bb.Tree(args.root)
    torch = T.torch
    if not torch.cuda.is_available():
        print("ilv_bench: no CUDA device", file=sys.stderr)
        return 2
    from bowtie_tpu_torch.align import pe_ilv_device as ilv
    kd = bb._kdiag()
    dev = torch.device("cuda")
    os.makedirs(args.work, exist_ok=True)
    t = time.time()
    T.kernels.lib()
    with open(os.path.join(T.root, "bowtie_tpu_torch", "csrc", "build",
                           "ptxas.txt")) as f:
        report = kd.ptxas_entry(f.read(), "ilv_kernel")
    res = {"root": T.root, "tag": args.tag,
           "kernel_build_s": time.time() - t, "ptxas": report, "cases": {}}
    if hasattr(ilv, "ilv_local_bytes"):
        res["local_bytes"] = ilv.ilv_local_bytes()
    inputs = make_inputs(T, args, dev)
    for name in args.cases.split(","):
        pair, S, st = inputs[name]
        out, it = ilv.run_ilv(pair, st, S)
        torch.cuda.synchronize()
        o = {k: v.cpu().numpy() for k, v in out.items()}
        its = it.cpu().numpy()
        np.savez(os.path.join(args.work, f"{args.tag}.{name}.npz"),
                 iterations=its, **o)
        B = int(its.shape[0])
        row = dict(pairs=CASES[name][0], lanes=B, Lq=S.Lq, SPAN=S.SPAN,
                   dense=S.dense, decided=int((o["escalate"] == 0).sum()),
                   found=int(o["res_found"].sum()),
                   budget_lanes=int((o["mode"] != ilv.I_DONE).sum()),
                   **bb.spread(bb.kernel_ms(
                       T, lambda: ilv.run_ilv(pair, st, S), args.reps,
                       ("pe_ilv",))),
                   call=bb.spread(bb.call_ms(
                       T, lambda: ilv.run_ilv(pair, st, S), 5)),
                   lanes_stats=kd.lane_stats(its))
        if hasattr(ilv, "ilv_window"):
            row["shape"] = ilv.ilv_shape(B, S.Lq)
            row["window"] = ilv.ilv_window(S.SPAN, S.Lq)
        if args.diag:
            row.update(diag(T, ilv, pair, S, st, its, kd))
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
    bb.check_equal(args.work, args.compare, runs[0]["cases"])
    table = {name: {r["tag"]: [r["cases"][name][k] for k in
                               ("ms", "ms_min", "ms_max")]
                    + [r["cases"][name]["call"]["ms"]] for r in runs}
             for name in runs[0]["cases"]}
    print(json.dumps({"equal_outputs_and_iterations": True,
                      "kernel_ms_median_min_max_and_call_ms": table,
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

"""Multi-process launch: torch.distributed and read slices.

A port of bowtie_tpu/parallel/launch.py.  Every process (rank) joins one
process group, aligns its contiguous slice of the read file through the
port's CLI (cli.align.main) on its own device, and writes part files;
after the ranks have finished, rank 0 merges the parts in rank order.
The merged output is what one process writes for the same command, byte
for byte, where the reference's merge is not (ROADMAP, queue 3):

- a user's own -s/-u apply before the split: rank k aligns reads
  [S + k*per, S + (k+1)*per) of [S, S + min(U, total - S));
- under -S, rank 0 alone writes the @HD/@SQ/@PG header, with the user's
  command line;
- --un/--al/--max write part files of their own, merged as the hits are;
- the ranks send their counts to rank 0 (gather_object), which prints the
  stderr summary once.

Usage (the same command in every process, each with its --host-id):

  python -m bowtie_tpu_torch.parallel.launch \\
      --coordinator localhost:29500 --num-hosts 2 --host-id $ID \\
      -- -n 2 -x <ebwt-base> reads.fq hits.txt

Rank k runs on cuda:{k mod the device count}: ranks may share a card.
The process group uses gloo, not NCCL: the ranks exchange only host
objects, and NCCL refuses two ranks on one GPU.  The first kernel build
may run in several ranks at once; kernels.build writes a pid-tagged file
and renames it into place, so that is safe.  The read file is split by
position, so input must be single-end (-1/-2, --12 and --interleaved are
refused), as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import sys
import traceback

import torch

from ..align.policy import AlignStats
from ..cli import align as cli
from ..utils.device import resolve_device


def _open_maybe_compressed(path: str):
    if path.endswith(".gz"):
        import gzip
        return gzip.open(path, "rb")
    if path.endswith(".bz2"):
        import bz2
        return bz2.open(path, "rb")
    return open(path, "rb")


def _count_reads(path: str, fmt: str = "fastq") -> int:
    """Count reads in `path` for host-slice arithmetic.  Handles
    multi-line FASTA, 4-line FASTQ, raw (1/line), tabbed (1/line) and
    gz/bz2 compression — a wrong count here would misalign global read
    ids (and therefore per-read RNG seeds) across hosts."""
    n = 0
    with _open_maybe_compressed(path) as f:
        if fmt == "fasta":
            for line in f:
                if line.startswith(b">"):
                    n += 1
        elif fmt == "fastq":
            for _ in f:
                n += 1
            n //= 4
        else:                      # raw / tabbed: one read per line
            for line in f:
                if line.strip():
                    n += 1
    return n


def _fmt_from_opts(opts: list[str]) -> str:
    if "-f" in opts:
        return "fasta"
    if "-r" in opts:
        return "raw"
    if "--12" in opts or "--tab5" in opts or "--tab6" in opts:
        return "tab"
    return "fastq"


def part_path(path: str, rank: int) -> str:
    """Rank `rank`'s part of output file `path`."""
    return f"{path}.part{rank}"


def slice_of(rank: int, ranks: int, total: int, skip: int,
             upto: int | None) -> tuple[int, int]:
    """(-s, -u) of rank `rank`: its contiguous share of the reads the
    user's -s `skip` / -u `upto` select from `total`."""
    n = max(0, total - skip)
    if upto is not None:
        n = min(n, upto)
    per = -(-n // ranks)
    return skip + rank * per, max(0, min(per, n - rank * per))


def _dump_files(base: str) -> list[str]:
    """Every file a --un/--al/--max dump named `base` may write: the base,
    and the two mate files of paired reads (cli.align._DumpStream)."""
    d = cli._DumpStream(base, False, "fastq")
    return [base, d._mate_name(1), d._mate_name(2)]


def _concat(dest: str, parts: list[str]) -> None:
    with open(dest, "wb") as out:
        for pp in parts:
            with open(pp, "rb") as f:
                out.write(f.read())
            os.remove(pp)


def merge(hits: str, dumps: list[str], ranks: int) -> None:
    """Concatenate the ranks' part files in rank order into `hits` and
    into each dump file that some rank wrote, removing the parts."""
    _concat(hits, [part_path(hits, k) for k in range(ranks)])
    for base in dumps:
        names = list(zip(*(_dump_files(part_path(base, k))
                           for k in range(ranks))))
        for dest, parts in zip(_dump_files(base), names):
            have = [pp for pp in parts if os.path.exists(pp)]
            if have:
                _concat(dest, have)


def _sum_stats(stats: list[AlignStats]) -> AlignStats:
    return AlignStats(**{f.name: sum(getattr(s, f.name) for s in stats)
                         for f in dataclasses.fields(AlignStats)})


def main(argv=None, device=None) -> int:
    """Run this process's rank; `device` (default cuda:{host id mod the
    device count}) is where it aligns — the tests pass "cpu"."""
    p = argparse.ArgumentParser(prog="bowtie-tpu-torch-distributed")
    p.add_argument("--coordinator", required=True,
                   help="host:port of rank 0 (torch.distributed)")
    p.add_argument("--num-hosts", type=int, required=True)
    p.add_argument("--host-id", type=int, required=True)
    p.add_argument("--no-merge", action="store_true",
                   help="leave the per-rank part files unmerged")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="-- then bowtie-tpu-torch arguments")
    args = p.parse_args(argv)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    if len(rest) < 3:
        p.error("expected: -- <bowtie-tpu-torch args> <ebwt> <reads> "
                "<hits>")
    user = cli.build_parser().parse_args(rest)
    if cli._paired(user) or user.mates2:
        p.error("the launcher splits single-end read files only")
    # the trailing positionals: <ebwt> <reads> <hits>, or <reads> <hits>
    # after -x <ebwt>; the rank's own options go before them
    npos = 2 if user.index_opt is not None else 3
    reads, hits = rest[-2], rest[-1]
    if [user.ebwt_base, user.reads, user.hits][:npos] != rest[-npos:]:
        p.error("expected the reads and hits files last")
    opts, pos = rest[:-npos], rest[-npos:-1]
    rank, ranks = args.host_id, args.num_hosts
    if device is None:
        resolve_device(None)            # raises without CUDA
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{args.coordinator}",
                            world_size=ranks, rank=rank,
                            timeout=datetime.timedelta(hours=24))
    try:
        skip, upto = slice_of(rank, ranks,
                              _count_reads(reads, _fmt_from_opts(opts)),
                              user.skip, user.qupto)
        dumps = list(dict.fromkeys(
            f for f in (user.un, user.al, user.maxfile) if f))
        mine = ["-s", str(skip), "-u", str(upto)]
        for flag, path in (("--un", user.un), ("--al", user.al),
                           ("--max", user.maxfile)):
            if path:
                mine += [flag, part_path(path, rank)]
        part = cli.Part(cmdline=" ".join(rest), first=rank == 0)
        try:
            rc = cli.main([*opts, *mine, *pos, part_path(hits, rank)],
                          device=dev, part=part)
        except Exception:
            traceback.print_exc()
            rc = 1
        got = [None] * ranks if rank == 0 else None
        dist.gather_object((rc or 0, part.stats), got, dst=0)
        if rank != 0:
            return rc or 0
        bad = [r for r, _ in got if r]
        if bad:
            print(f"{len(bad)} of {ranks} ranks failed", file=sys.stderr)
            return bad[0]
        if not args.no_merge:
            merge(hits, dumps, ranks)
        cli.print_summary(user, _sum_stats([s for _, s in got]))
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())

"""bowtie-build-compatible CLI.

Usage:
    python -m bowtie_tpu_torch.cli.build [options] <reference_in> <ebwt_base>

Option surface mirrors ebwt_build.cpp:152-181, as bin/bowtie-tpu-build's
does, and writes the same bytes.  The suffix array is SA-IS on the host,
or, with --jax-sa (spelled as bin/bowtie-tpu-build spells it, so that
command lines stay interchangeable), prefix doubling on the GPU: one K16
launch a round (build/sa.py, csrc/sa.cu).  Flags that only select the
reference's blockwise-SA memory strategy (--bmax/--bmaxdivn/--dcv/
--nodc/--entiresa/-a/--noauto/-p/--packed) are accepted for
compatibility; here they tune the bounded-memory external SA build
instead (build/blockwise.py, host numpy, which --jax-sa does not change)
— SA-IS plus external bucketing replaces the Kärkkäinen blockwise scheme
and yields the identical index bytes.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
import time

from ..build import builder
from ..build.sa import suffix_array, suffix_array_doubling
from ..utils.alphabet import seq_to_codes
from ..utils.device import resolve_device


def main(argv=None, device=None) -> int:
    """Build an index.  `device` (default CUDA) is where --jax-sa builds
    the suffix array; it is resolved only with --jax-sa, and the tests
    pass "cpu" for the plain round."""
    p = argparse.ArgumentParser(prog="bowtie-tpu-torch-build")
    p.add_argument("reference_in",
                   help="comma-separated FASTA files (or sequences with -c)")
    p.add_argument("ebwt_base")
    p.add_argument("-f", dest="fasta", action="store_true",
                   help="reference files are FASTA (default)")
    p.add_argument("-c", dest="cmdline", action="store_true")
    p.add_argument("-o", "--offrate", type=int, default=5)
    p.add_argument("-t", "--ftabchars", type=int, default=10)
    p.add_argument("--noref", "-r", action="store_true",
                   help="don't build .3/.4 reference portion")
    p.add_argument("-3", "--justref", dest="justref", action="store_true",
                   help="just build the .3/.4 reference portion")
    p.add_argument("--norev", action="store_true",
                   help="skip the mirror (.rev) index")
    p.add_argument("--large-index", action="store_true",
                   help="write the 64-bit .ebwtl variant")
    p.add_argument("--jax-sa", action="store_true",
                   help="build the suffix array on the GPU (prefix "
                        "doubling, one K16 kernel launch a round)")
    p.add_argument("--ntoa", action="store_true",
                   help="convert Ns in reference to As")
    p.add_argument("--big", dest="big_endian", action="store_true",
                   help="write big-endian index files")
    p.add_argument("--little", dest="big_endian", action="store_false")
    # memory-strategy flags (reference blockwise-SA dials; here they
    # configure the bounded-memory external build)
    p.add_argument("--bmax", type=int, default=None,
                   help="max suffix-bucket size for the bounded-memory "
                        "SA build")
    p.add_argument("--bmaxmultsqrt", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--bmaxdivn", type=int, default=4,
                   help="max bucket size as divisor of ref len")
    p.add_argument("--dcv", type=int, default=1024, help=argparse.SUPPRESS)
    p.add_argument("--nodc", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--entiresa", action="store_true",
                   help="build the whole SA in memory (disable the "
                        "bounded-memory path)")
    p.add_argument("-a", "--noauto", action="store_true",
                   help="disable automatic memory fitting")
    p.add_argument("-p", "--packed", action="store_true",
                   help=argparse.SUPPRESS)   # strings are always packed
    p.add_argument("--threads", type=int, default=1,
                   help=argparse.SUPPRESS)
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed (output is deterministic regardless: "
                        "the SA is unique)")
    p.add_argument("-s", "--sanity", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--wrapper", default=None, help=argparse.SUPPRESS)
    p.add_argument("--version", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-n", "--noblocks", default=None,
                   help="one SA block (reference sets bmax=0xfffffffe;"
                        " the in-memory build here)")
    p.add_argument("-l", "--linerate", type=int, default=None,
                   help="side geometry (only the default is supported)")
    p.add_argument("-i", "--linesperside", type=int, default=None,
                   help="side geometry (only the default is supported)")
    p.add_argument("--new-reverse", action="store_true",
                   help="mirror index = entire joined text reversed "
                        "(REF_READ_REVERSE) instead of each fragment "
                        "reversed in place")
    p.add_argument("--usage", action="help", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.version:
        print("bowtie-tpu-torch-build (compatible with bowtie-build "
              "1.3.1)")
        return 0
    if not args.large_index and not args.cmdline:
        # the reference wrapper auto-selects the large-index builder
        # when the input FASTA files total > 4 GiB - 200
        # (bowtie-build script, small_index_max_size)
        tot = sum(os.path.getsize(f)
                  for f in args.reference_in.split(",")
                  if os.path.exists(f))
        if tot > 4 * 1024 ** 3 - 200:
            args.large_index = True
    default_lr = 7 if args.large_index else 6
    if ((args.linerate is not None and args.linerate != default_lr) or
            (args.linesperside is not None and args.linesperside != 1)):
        print("Error: non-default -l/--linerate / -i/--linesperside "
              "side geometries are not supported by bowtie-tpu-build",
              file=sys.stderr)
        return 1
    if args.noblocks is not None:
        args.entiresa = True

    sa_fn = suffix_array
    if args.jax_sa:
        sa_fn = functools.partial(suffix_array_doubling,
                                  device=resolve_device(device))
    byteorder = ">" if args.big_endian else "<"

    t0 = time.time()
    # bounded-memory path: explicit --bmax/--bmaxdivn selection, or
    # automatically for very large references; --entiresa forces the
    # in-memory SA-IS build (its MemoryError still ladders down unless
    # -a/--noauto)
    blockwise = (not args.entiresa and
                 (args.bmax is not None or args.bmaxdivn != 4))
    kw = dict(off_rate=args.offrate, ftab_chars=args.ftabchars,
              sa_fn=sa_fn, both=not args.norev, large=args.large_index,
              ntoa=args.ntoa, write_ref=not args.noref,
              just_ref=args.justref, byteorder=byteorder,
              blockwise=blockwise, bmax=args.bmax,
              bmax_divn=args.bmaxdivn, dcv=args.dcv,
              auto_mem=not args.noauto, new_reverse=args.new_reverse)
    if args.cmdline:
        seqs = [seq_to_codes(s) for s in args.reference_in.split(",")]
        names = [str(i) for i in range(len(seqs))]
        builder.build_index(seqs, names, args.ebwt_base, **kw)
    else:
        builder.build_from_fasta(args.reference_in.split(","),
                                 args.ebwt_base, **kw)
    if not args.quiet:
        print(f"Total time for build: {time.time() - t0:.2f}s",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

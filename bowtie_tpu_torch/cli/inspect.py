"""bowtie-inspect-compatible CLI.

Usage: python -m bowtie_tpu_torch.cli.inspect [options] <ebwt_base>

Option surface and output as bin/bowtie-tpu-inspect's (host numpy only).
"""
from __future__ import annotations

import argparse
import sys

from ..build.inspect import inspect


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bowtie-tpu-torch-inspect")
    p.add_argument("ebwt_base")
    p.add_argument("-a", "--across", type=int, default=60)
    p.add_argument("-n", "--names", action="store_true")
    p.add_argument("-s", "--summary", action="store_true")
    p.add_argument("-e", "--ebwt-ref", action="store_true",
                   help="reconstruct reference from the BWT (LF walk) "
                        "instead of the .3/.4 files")
    p.add_argument("--extra", action="store_true",
                   help="extra summary lines with -s "
                        "(bowtie_inspect.cpp:377-403)")
    p.add_argument("--excl-ambig", action="store_true",
                   help=argparse.SUPPRESS)   # ACCOUNT_FOR_ALL_GAP_REFS
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--version", action="store_true")
    p.add_argument("--usage", action="help", help=argparse.SUPPRESS)
    p.add_argument("--wrapper", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.version:
        print("bowtie-tpu-torch-inspect (compatible with bowtie-inspect "
              "1.3.1)")
        return 0

    inspect(args.ebwt_base, names_only=args.names, summary=args.summary,
            across=args.across, use_ebwt=args.ebwt_ref,
            extra=args.extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())

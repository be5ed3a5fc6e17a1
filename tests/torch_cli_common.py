"""The shared input of the CLI parity modules (tests/test_torch_cli*.py):
an index built in tmp_path from a seeded genome with planted repeats (a
module-scoped fixture, so each module builds its own, which takes well
under a second) and its reads, and the run helper that returns a CLI
run's exit code, output without its @PG line and stderr.  Not a test
module: the test modules import `data` and `_run` from here."""
import contextlib
import io

import numpy as np
import pytest

from bowtie_tpu_torch.build.builder import build_index
from bowtie_tpu_torch.utils.alphabet import codes_to_seq


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(2024)
    rep = rng.integers(0, 4, 300).astype(np.uint8)
    seqs = []
    for ln in (7000, 5000, 3000):
        s = rng.integers(0, 4, ln).astype(np.uint8)
        for p in rng.integers(0, ln - 300, 3):       # planted repeats
            s[p:p + 300] = rep
        seqs.append(s)
    seqs[1][2000:2040] = 4                           # a gap: 2 fragments
    base = str(d / "genome")
    build_index(seqs, ["chrA first", "chrB", "chrC"], base)
    (d / "genome.fa").write_text("".join(
        f">chr{c}\n{codes_to_seq(s[:3000])}\n" for c, s in zip("ABC", seqs)))
    lines, fasta, raw = [], [], []
    for k in range(400):
        s = seqs[int(rng.integers(3))]
        ln = int(rng.integers(4, 50))
        p = int(rng.integers(0, len(s) - ln))
        q = s[p:p + ln].copy()
        kind = k % 5
        if kind == 1:
            q = (3 - np.minimum(q, 3)[::-1]).astype(np.uint8)
        elif kind == 2:
            q[int(rng.integers(ln))] = rng.integers(4)
        elif kind == 3:
            q[int(rng.integers(ln))] = 4
        seq = codes_to_seq(q)
        qual = "".join(chr(33 + int(x)) for x in rng.integers(0, 41, ln))
        lines.append(f"@read{k} extra\n{seq}\n+\n{qual}\n")
        fasta.append(f">read{k}\n{seq}\n")
        raw.append(seq + "\n")
    reads = d / "reads.fq"
    reads.write_text("".join(lines))
    (d / "reads.fa").write_text("".join(fasta))
    (d / "reads.raw").write_text("".join(raw))
    return base, str(reads), d


def _run(main, args, out, **kw):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(args + [out], **kw)
    with open(out, "rb") as f:
        body = [ln for ln in f.read().splitlines(keepends=True)
                if not ln.startswith(b"@PG")]
    return rc, b"".join(body), err.getvalue()

"""The single-end rows of the declarative case table of
tests/test_simple_cases.py through both CLIs: the port's (on the CPU, its
plain versions) against bowtie_tpu.cli.align.main, on an index built by
the port's builder from that table's genome.  Every artifact — the hits
file and every --al/--un/--max dump, including which files exist — and
the stderr summary must be byte-identical (@PG aside).

Rows taken: every single-end row (FASTQ in its variants, FASTA, raw, -c,
-F), the best-first rows (--best, --strata, -M, -v 3) included, which the
port runs on its best-first machine (align/best_device.py).  The reference
side runs its host engines (BOWTIE_TPU_HOST_ENGINE=1), as the table's own
test does, which byte-match its device engines (tests/test_*_device.py);
rows with -p keep its device engines, since -p forks the host engines."""
import contextlib
import gzip
import io
import os

import pytest

from bowtie_tpu.cli import align as jcli
from bowtie_tpu_torch.build.builder import build_from_fasta
from bowtie_tpu_torch.cli import align as tcli
from test_simple_cases import (CASES, GENOME, LONG_READS, SE_READS, _expand,
                               _fa_text, _fq_text, _int_qual_fq_text,
                               _raw_text, _tree)

SE_KINDS = {"fq", "fq+", "fa", "raw", "c", "F", "fq64", "fqint", "fqlong",
            "fqcrlf", "fq2", "fqgz"}
ROWS = [c for c in CASES if c[1] in SE_KINDS]


def _best_first(case_args) -> bool:
    return bool({"--best", "-M"} & set(case_args)) or (
        "-v" in case_args and case_args[case_args.index("-v") + 1] == "3")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The table's inputs (tests/test_simple_cases.py env) with the index
    built by the port's builder."""
    d = tmp_path_factory.mktemp("torch_cases")
    fa = d / "genome.fa"
    with open(fa, "w") as f:
        for nm, seq in GENOME:
            f.write(f">{nm}\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + "\n")
    base = str(d / "idx")
    build_from_fasta([str(fa)], base)
    texts = {
        "fq": _fq_text(SE_READS),
        "fq+": _fq_text(SE_READS, plus_name=True),
        "fq64": _fq_text(SE_READS, qshift=31),
        "fqint": _int_qual_fq_text(SE_READS),
        "fa": _fa_text(SE_READS),
        "fqlong": _fq_text(LONG_READS),
        "fqcrlf": _fq_text(SE_READS).replace("\n", "\r\n"),
        "raw": _raw_text(SE_READS),
    }
    files = {}
    for key, text in texts.items():
        (d / f"in_{key}.txt").write_text(text)
        files[key] = ("READS", str(d / f"in_{key}.txt"))
    with gzip.open(d / "in_fq.txt.gz", "wt") as f:
        f.write(_fq_text(SE_READS))
    files["fqgz"] = ("READS", str(d / "in_fq.txt.gz"))
    recs = _fq_text(SE_READS).splitlines(keepends=True)
    half = (len(recs) // 8 // 2) * 4
    (d / "in_fq_a.txt").write_text("".join(recs[:half]))
    (d / "in_fq_b.txt").write_text("".join(recs[half:]))
    files["fq2"] = ("READS", f"{d}/in_fq_a.txt,{d}/in_fq_b.txt")
    return {"base": base, "genome": str(fa), "files": files}


def _summary(text):
    keep = ("# ", "Reported ", "No alignments", "reporter:")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def _tree_no_pg(d, sam):
    out = _tree(d)
    if sam and "out" in out:
        out["out"] = b"".join(ln for ln in out["out"].splitlines(True)
                              if not ln.startswith(b"@PG"))
    return out


def _run(main, args, **kw):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(args, **kw)
    return rc, _summary(err.getvalue())


@pytest.mark.parametrize("cid,infmt,case_args", ROWS,
                         ids=[c[0] for c in ROWS])
def test_case_parity(cid, infmt, case_args, env, tmp_path, monkeypatch):
    if "-p" not in case_args:
        monkeypatch.setenv("BOWTIE_TPU_HOST_ENGINE", "1")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    os.makedirs(jdir)
    os.makedirs(tdir)
    want = _run(jcli.main, _expand(case_args, infmt, env, jdir)[0])
    monkeypatch.delenv("BOWTIE_TPU_HOST_ENGINE", raising=False)
    got = _run(tcli.main, _expand(case_args, infmt, env, tdir)[0],
               device="cpu")
    assert want[0] in (0, None) and got[0] == 0
    assert got[1] == want[1]
    sam = "-S" in case_args
    assert _tree_no_pg(tdir, sam) == _tree_no_pg(jdir, sam)


def test_rows_cover_the_table():
    """Every single-end row is taken, the 18 best-first rows (--best, -M,
    -v 3) among them; the rows left out are the paired-end ones."""
    assert len(ROWS) > 90
    assert sum(_best_first(c[2]) for c in ROWS) == 18
    left = [c for c in CASES if c not in ROWS]
    assert left and all(c[1] not in SE_KINDS for c in left)

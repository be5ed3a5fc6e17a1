"""The port's multi-process launcher (parallel/launch.py): ranks run as
subprocesses of `python -m bowtie_tpu_torch.parallel.launch` on the CPU,
joined by a gloo process group on a free localhost port (as
tests/test_distributed.py runs the reference's launcher), on an index
built here.  The merged output must equal one process's run byte for
byte: the verbose hits of -v 0 equal what bowtie_tpu.cli.align.main
writes, and every case's hits, --un/--al/--max dumps and rank 0's stderr
equal what the port's cli.align.main writes in one process — under -S
with one header carrying the user's command line, under a user's own
-s/-u, and with a rank whose slice is empty."""
import contextlib
import gzip
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from bowtie_tpu.cli import align as jcli
from bowtie_tpu_torch.build.builder import build_index
from bowtie_tpu_torch.cli import align as tcli
from bowtie_tpu_torch.parallel.launch import (_count_reads, _fmt_from_opts,
                                              slice_of)
from bowtie_tpu_torch.utils.alphabet import codes_to_seq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NREADS = 300


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_launch")
    rng = np.random.default_rng(404)
    rep = rng.integers(0, 4, 200).astype(np.uint8)
    seqs = []
    for ln in (6000, 4000):
        s = rng.integers(0, 4, ln).astype(np.uint8)
        for p in rng.integers(0, ln - 200, 3):       # planted repeats
            s[p:p + 200] = rep
        seqs.append(s)
    base = str(d / "genome")
    build_index(seqs, ["chrA", "chrB"], base)
    lines = []
    for k in range(NREADS):
        s = seqs[k % 2]
        ln = int(rng.integers(20, 40))
        p = int(rng.integers(0, len(s) - ln))
        q = s[p:p + ln].copy()
        if k % 4 == 1:
            q = (3 - q[::-1]).astype(np.uint8)
        elif k % 4 == 2:
            q[int(rng.integers(ln))] = rng.integers(4)
        elif k % 8 == 3:
            q[int(rng.integers(ln))] = 4
        elif k % 8 == 7:
            q = rng.integers(0, 4, ln).astype(np.uint8)
        qual = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, ln))
        lines.append(f"@read{k}\n{codes_to_seq(q)}\n+\n{qual}\n")
    reads = d / "reads.fq"
    reads.write_text("".join(lines))
    return base, str(reads), d


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(cwd, ranks, rest):
    """Run `ranks` ranks of the launcher in `cwd` (outputs named relative
    to it); -> (exit codes, stderr of each rank)."""
    os.makedirs(cwd, exist_ok=True)
    port = _free_port()
    # TORCH_CPP_LOG_LEVEL: torch's own c10d warnings (a host whose name
    # does not resolve draws one) stay out of the compared stderr
    env = dict(os.environ, PYTHONPATH=ROOT, TORCH_CPP_LOG_LEVEL="ERROR")
    flags = ["--coordinator", f"localhost:{port}", "--num-hosts",
             str(ranks)]
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "from bowtie_tpu_torch.parallel.launch import main; "
         "raise SystemExit(main("
         f"{flags + ['--host-id', str(k), '--', *rest]!r}, device='cpu'))"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for k in range(ranks)]
    outs = [p.communicate(timeout=600) for p in procs]
    return [p.returncode for p in procs], [e for _o, e in outs]


def _single(cwd, main, rest, **kw):
    """One process's run of `rest` in `cwd`; -> its stderr."""
    os.makedirs(cwd, exist_ok=True)
    err = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stderr(err):
            assert main(rest, **kw) == 0
    finally:
        os.chdir(old)
    return err.getvalue().encode()


def _files(cwd):
    return {f: open(os.path.join(cwd, f), "rb").read()
            for f in sorted(os.listdir(cwd))}


CASES = [
    # name, ranks, options (outputs relative to the run's directory)
    ("v0", 2, ["-v", "0"]),
    ("v0_S_skip_upto_un", 3, ["-v", "0", "-S", "-s", "17", "-u", "150",
                              "--un", "un.fq"]),
    ("v1_a_m1_dumps", 2, ["-v", "1", "-a", "-m", "1", "-S", "--al",
                          "al.fq", "--max", "max.fq", "--un", "un.fq"]),
    ("n2_tail", 3, ["-n", "2", "-s", str(NREADS - 2)]),
    ("x_v0_k2", 2, ["-v", "0", "-k", "2", "-S", "-x"]),
]


@pytest.mark.parametrize("name,ranks,opts", CASES,
                         ids=[c[0] for c in CASES])
def test_launch_merge_equals_single(data, tmp_path, name, ranks, opts):
    base, reads, _d = data
    rest = opts + [base, reads, "hits.out"]
    rcs, errs = _launch(str(tmp_path / "dist"), ranks, rest)
    assert rcs == [0] * ranks, b"".join(errs).decode()
    want_err = _single(str(tmp_path / "one"), tcli.main, rest, device="cpu")
    got, want = _files(tmp_path / "dist"), _files(tmp_path / "one")
    assert got == want                    # no part file is left either
    assert len(want["hits.out"]) > 0 or name == "n2_tail"
    assert all(want.get(f) for f in opts if f.endswith(".fq"))
    assert errs[0] == want_err
    assert b"# reads processed" in want_err
    assert all(b"# reads" not in e for e in errs[1:])
    if "-S" in opts:
        assert want["hits.out"].count(b"@HD") == 1
        assert f"CL:\"{' '.join(rest)}\"".encode() in want["hits.out"]
    if name == "v0":
        # the reference's own CLI in one process writes the same hits
        _single(str(tmp_path / "jax"), jcli.main, rest)
        assert _files(tmp_path / "jax")["hits.out"] == got["hits.out"]
    if name == "n2_tail":
        assert b"# reads processed: 2\n" in want_err


def test_slice_of():
    """Each rank's -s/-u: contiguous shares of the user's selection."""
    assert [slice_of(k, 2, 300, 0, None) for k in range(2)] == [
        (0, 150), (150, 150)]
    assert [slice_of(k, 3, 300, 17, 150) for k in range(3)] == [
        (17, 50), (67, 50), (117, 50)]
    assert [slice_of(k, 3, 300, 298, None) for k in range(3)] == [
        (298, 1), (299, 1), (300, 0)]
    assert [slice_of(k, 2, 10, 20, 5) for k in range(2)] == [
        (20, 0), (20, 0)]


def test_count_reads_formats(tmp_path):
    """Read counting must handle FASTA (multi-line), FASTQ, raw and gz
    — a wrong count would skew per-rank slices."""
    fa = tmp_path / "x.fa"
    fa.write_text(">a\nACGT\nACGT\n>b\nGGGG\n>c\nTT\nTT\nTT\n")
    fq = tmp_path / "x.fq"
    fq.write_text("@a\nACGT\n+\nIIII\n@b\nGG\n+\nII\n")
    raw = tmp_path / "x.raw"
    raw.write_text("ACGT\nGGGG\n\n")
    fqgz = tmp_path / "x.fq.gz"
    with gzip.open(fqgz, "wt") as f:
        f.write("@a\nACGT\n+\nIIII\n@b\nGG\n+\nII\n@c\nAA\n+\nII\n")
    assert _count_reads(str(fa), "fasta") == 3
    assert _count_reads(str(fq), "fastq") == 2
    assert _count_reads(str(raw), "raw") == 2
    assert _count_reads(str(fqgz), "fastq") == 3
    assert _fmt_from_opts(["-f", "-v", "0"]) == "fasta"
    assert _fmt_from_opts(["-r"]) == "raw"
    assert _fmt_from_opts(["--12"]) == "tab"
    assert _fmt_from_opts(["-v", "0"]) == "fastq"

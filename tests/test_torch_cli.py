"""CLI parity: the PyTorch port's -v 0, -v 1 and -v 2 aligners (on the
CPU) against bowtie_tpu.cli.align.main, byte for byte — hits file and
stderr summary — on an index built in tmp_path from a seeded genome with
planted repeats."""
import contextlib
import io

import numpy as np
import pytest

from bowtie_tpu.cli import align as jcli
from bowtie_tpu_torch.build.builder import build_index
from bowtie_tpu_torch.cli import align as tcli
from bowtie_tpu_torch.utils.alphabet import codes_to_seq

CASES = [
    ("k1", ["-v", "0"]),
    ("k1_seed", ["-v", "0", "--seed", "7"]),
    ("k3", ["-v", "0", "-k", "3"]),
    ("a", ["-v", "0", "-a"]),
    ("m1", ["-v", "0", "-m", "1"]),
    ("a_m3", ["-v", "0", "-a", "-m", "3"]),
    ("nofw", ["-v", "0", "--nofw"]),
    ("norc", ["-v", "0", "--norc", "-k", "2"]),
    ("S", ["-v", "0", "-S"]),
    ("S_a_m2", ["-v", "0", "-S", "-a", "-m", "2", "--batch-size", "97"]),
    ("verbose_opts", ["-v", "0", "-k", "2", "-B", "1", "--suppress", "6"]),
    ("trim", ["-v", "0", "-5", "3", "-3", "2"]),
    ("skip_upto", ["-v", "0", "-s", "10", "-u", "100", "-S"]),
    ("refidx", ["-v", "0", "--refidx", "-k", "2"]),
    ("fullref_S", ["-v", "0", "--fullref", "-S", "--sam-nohead"]),
    ("offrate", ["-v", "0", "-o", "7", "-a"]),
    ("phred64", ["-v", "0", "--phred64-quals", "--hadoopout"]),
]

# -v 1 / -v 2: the DFS machine (align/dfs_device.py) behind the exact gate
V_CASES = [
    ("v1_k1", ["-v", "1"]),
    ("v1_k3", ["-v", "1", "-k", "3"]),
    ("v2_a_m2", ["-v", "2", "-a", "-m", "2", "-u", "200"]),
    ("v2_S", ["-v", "2", "-S", "-s", "150", "-u", "200"]),
    ("v1_nofw_k2", ["-v", "1", "--nofw", "-k", "2"]),
    ("v2_norc", ["-v", "2", "--norc", "-u", "200"]),
    ("v2_seed_k2", ["-v", "2", "--seed", "5", "-k", "2", "-s", "200"]),
    ("v1_trim_S_a_m3", ["-v", "1", "-5", "2", "-3", "1", "-S", "-a", "-m",
                        "3", "--batch-size", "150"]),
    ("v1_offrate_a", ["-v", "1", "-o", "7", "-a"]),
]

# (name, flags, reads file made by the fixture)
FORMATS = [
    ("fasta", ["-v", "0", "-f", "-a"], "reads.fa"),
    ("raw", ["-v", "0", "-r", "-S"], "reads.raw"),
    ("fasta_cont", ["-v", "0", "-F", "30,7", "-m", "2"], "genome.fa"),
]


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


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_cli_parity(data, name, args):
    base, reads, d = data
    full = args + [base, reads]
    want = _run(jcli.main, full, str(d / f"{name}.jax"))
    got = _run(tcli.main, full, str(d / f"{name}.torch"), device="cpu")
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(want[1]) > 0


@pytest.mark.parametrize("name,args", V_CASES, ids=[c[0] for c in V_CASES])
def test_cli_v_parity(data, name, args):
    base, reads, d = data
    full = args + [base, reads]
    want = _run(jcli.main, full, str(d / f"{name}.jax"))
    got = _run(tcli.main, full, str(d / f"{name}.torch"), device="cpu")
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(want[1]) > 0


@pytest.mark.parametrize("name,args,reads", FORMATS,
                         ids=[c[0] for c in FORMATS])
def test_cli_input_format_parity(data, name, args, reads):
    base, _fq, d = data
    full = args + [base, str(d / reads)]
    want = _run(jcli.main, full, str(d / f"{name}.jax"))
    got = _run(tcli.main, full, str(d / f"{name}.torch"), device="cpu")
    assert got == want
    assert len(want[1]) > 0


def test_cli_cmdline_reads_parity(data, capsysbinary):
    base, _fq, d = data
    seqs = [codes_to_seq(np.random.default_rng(i).integers(0, 4, 12))
            for i in range(3)] + ["ACGTNACGTACG", "ACG"]
    outs = []
    for main, kw in ((jcli.main, {}), (tcli.main, {"device": "cpu"})):
        assert main(["-v", "0", "-a", base, "-c", ",".join(seqs)], **kw) == 0
        outs.append(capsysbinary.readouterr())
    assert outs[0] == outs[1]


def _dumps(data, v):
    base, reads, d = data
    outs = {}
    for tag, main, kw in (("jax", jcli.main, {}),
                          ("torch", tcli.main, {"device": "cpu"})):
        tag = tag + v
        args = ["-v", v, "-m", "1"] + (["-u", "250"] if v != "0" else []) + [
            "--un", str(d / f"un.{tag}"), "--al", str(d / f"al.{tag}"),
            "--max", str(d / f"max.{tag}"), base, reads]
        outs[tag] = _run(main, args, str(d / f"dump.{tag}"), **kw)
    assert outs["jax" + v] == outs["torch" + v]
    for kind in ("un", "al", "max"):
        want, got = d / f"{kind}.jax{v}", d / f"{kind}.torch{v}"
        assert want.exists() == got.exists()
        assert want.exists() or v != "0"     # -v 0 here writes all three
        assert not want.exists() or want.read_bytes() == got.read_bytes()


def test_cli_dumps_parity(data):
    _dumps(data, "0")


def test_cli_v_dumps_parity(data):
    _dumps(data, "2")

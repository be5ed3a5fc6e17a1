"""CLI parity: the PyTorch port's -v 0 aligner (on the CPU) against
bowtie_tpu.cli.align.main, byte for byte — hits file, dumps and stderr
summary — on an index built in tmp_path from a seeded genome with planted
repeats (tests/torch_cli_common.py), and on the in-repo .ebwtl index
(tests/golden/small_index_l); the input formats and the --un/--al/--max
dumps of -v 0, -v 2 and -n likewise.  The -v 1/2 and -n cases are in
test_torch_cli_vn.py, the best-first ones with --sanity, --stats and -p in
test_torch_cli_best.py."""
import os

import numpy as np
import pytest

from bowtie_tpu.cli import align as jcli
from bowtie_tpu_torch.cli import align as tcli
from bowtie_tpu_torch.index.ebwt_io import (read_bitpair_reference,
                                            read_ebwt, unpack_reference)
from bowtie_tpu_torch.utils.alphabet import codes_to_seq

from torch_cli_common import _run, data  # noqa: F401  (data: a fixture)

GOLD = os.path.join(os.path.dirname(__file__), "golden", "small_index",
                    "small_oracle")
GOLD_L = os.path.join(os.path.dirname(__file__), "golden", "small_index_l",
                      "small_oracle")

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

# (name, flags, reads file made by the fixture)
FORMATS = [
    ("fasta", ["-v", "0", "-f", "-a"], "reads.fa"),
    ("raw", ["-v", "0", "-r", "-S"], "reads.raw"),
    ("fasta_cont", ["-v", "0", "-F", "30,7", "-m", "2"], "genome.fa"),
]


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


@pytest.fixture(scope="module")
def gold_reads(tmp_path_factory):
    """Seeded 30-40 bp reads of the small reference (0-2 mismatches, some
    reverse complemented), and the exact 36-mers of its first fragment
    whose last ftabChars bases name an escaped ftab entry of the .ebwtl
    index (one that the reference package resolves as a range; ROADMAP,
    queue 3), for the in-repo indexes."""
    refs = unpack_reference(*read_bitpair_reference(GOLD))
    rng = np.random.default_rng(9)
    lines = []
    for k in range(120):
        r = refs[k % len(refs)]
        ln = int(rng.integers(30, 41))
        p = int(rng.integers(0, len(r) - ln))
        q = np.minimum(r[p:p + ln], 4).astype(np.uint8)
        for _ in range(k % 3):
            q[int(rng.integers(ln))] = rng.integers(4)
        if k % 2:
            q = (3 - np.minimum(q, 3)[::-1]).astype(np.uint8)
        qual = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, ln))
        lines.append(f"@g{k}\n{codes_to_seq(q)}\n+\n{qual}\n")
    idx = read_ebwt(GOLD_L)
    esc = set(np.nonzero(idx.ftab > np.uint64(idx.length))[0].tolist())
    fc, g = idx.ftab_chars, refs[0]
    weights = 4 ** np.arange(fc - 1, -1, -1)
    n_esc = 0
    for p in range(len(g) - 36):
        q = g[p:p + 36]
        foff = int((q[36 - fc:] * weights).sum())
        if (q < 4).all() and (foff in esc or foff + 1 in esc):
            lines.append(f"@esc{p}\n{codes_to_seq(q)}\n+\n{'I' * 36}\n")
            n_esc += 1
    assert n_esc > 0
    path = tmp_path_factory.mktemp("gold_reads") / "g.fq"
    path.write_text("".join(lines))
    return str(path)


@pytest.mark.parametrize("args", [["-n", "2"], ["-v", "1", "-S"],
                                  ["-v", "0", "-a"]],
                         ids=["n2", "v1_S", "v0_a"])
def test_cli_ebwtl_parity(gold_reads, tmp_path, args):
    """The .ebwtl index (64-bit offsets) through the port equals the .ebwt
    index of the same genome through both CLIs.  (The reference package
    on the .ebwtl index misses the esc* reads: ROADMAP, queue 3.)"""
    want = _run(jcli.main, args + [GOLD, gold_reads], str(tmp_path / "jax"))
    got = _run(tcli.main, args + [GOLD_L, gold_reads], str(tmp_path / "l"),
               device="cpu")
    small = _run(tcli.main, args + [GOLD, gold_reads], str(tmp_path / "s"),
                 device="cpu")
    assert got == want == small
    assert b"esc" in want[1]


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
        mode = ["-n", "2"] if v == "n" else ["-v", v]
        args = mode + ["-m", "1"] + (["-u", "250"] if v != "0" else []) + [
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


def test_cli_n_dumps_parity(data):
    _dumps(data, "n")

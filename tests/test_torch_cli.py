"""CLI parity: the PyTorch port's -v 0, -v 1, -v 2, -n and best-first
(--best, --strata, -M, -v 3) aligners (on the CPU) against
bowtie_tpu.cli.align.main, byte for byte — hits file, dumps and stderr
summary — on an index built in tmp_path from a seeded genome with planted
repeats, and on the in-repo .ebwtl index (tests/golden/small_index_l);
--sanity, --stats and -p likewise."""
import contextlib
import io
import os
import re

import numpy as np
import pytest

from bowtie_tpu.cli import align as jcli
from bowtie_tpu_torch.build.builder import build_index
from bowtie_tpu_torch.cli import align as tcli
from bowtie_tpu_torch.index.ebwt_io import (read_bitpair_reference,
                                            read_ebwt, unpack_reference)
from bowtie_tpu_torch.utils.alphabet import codes_to_seq

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

# -n (bowtie's default mode when no -v is given): launches A and B of the
# DFS machine with K9 between them (align/n_device.py).  The reference CLI
# runs its DeviceNAligner, which on a CPU backend derives launch B's jobs on
# the host (_jobs_b), so these also hold K9's plain version to that
# derivation.
N_CASES = [
    ("n_default", []),
    ("n2", ["-n", "2"]),
    ("n2_S", ["-n", "2", "-S", "-u", "200"]),
    ("n1_a", ["-n", "1", "-a", "-u", "200"]),
    ("n3_l20_e100", ["-n", "3", "-l", "20", "-e", "100"]),
    ("n2_nomaqround", ["-n", "2", "--nomaqround"]),
    ("n2_maxbts1", ["--maxbts", "1", "-n", "2"]),
    ("n0_norc", ["-n", "0", "--norc"]),
    ("n2_nofw_k2", ["-n", "2", "--nofw", "-k", "2"]),
    ("n2_trim_e90", ["-5", "2", "-3", "2", "-n", "2", "-e", "90"]),
    ("n2_seed_k2", ["--seed", "5", "-n", "2", "-k", "2"]),
]

# the best-first engine (align/best_device.py): -v's driver DAGs and -n's
# seeded one, with --strata, -M sampling (SAM and verbose) and -m
BEST_CASES = [
    ("v3_k2_S", ["-v", "3", "-k", "2", "-S", "-u", "150"]),
    ("v1_best_strata_m1", ["-v", "1", "--best", "--strata", "-m", "1",
                           "-u", "200"]),
    ("v2_M2_S", ["-v", "2", "-M", "2", "--best", "-S", "-u", "150"]),
    ("n2_M1", ["-n", "2", "-M", "1", "--best", "-u", "150"]),
    ("n3_l20_best_k2", ["-n", "3", "-l", "20", "--best", "-k", "2",
                        "-u", "100"]),
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


# Trimming leaves reads of 1-3 bases, which phase 1 of -n refuses
# (search_seeded_phase1.c; the host oracle's _run_n) and the reference's
# device engine reports through its exact gate (ROADMAP, queue 3): these
# cases are held to the reference's host engine, which gives bowtie's
# answer, and differ from its device engine on those reads alone.
HOST_REF = {"n2_trim_e90"}


@pytest.mark.parametrize("name,args", N_CASES, ids=[c[0] for c in N_CASES])
def test_cli_n_parity(data, name, args, monkeypatch):
    base, reads, d = data
    full = args + [base, reads]
    want = dev = _run(jcli.main, full, str(d / f"{name}.jax"))
    if name in HOST_REF:
        monkeypatch.setenv("BOWTIE_TPU_HOST_ENGINE", "1")
        want = _run(jcli.main, full, str(d / f"{name}.jaxhost"))
        monkeypatch.delenv("BOWTIE_TPU_HOST_ENGINE")
        diff = set(dev[1].splitlines()) ^ set(want[1].splitlines())
        assert diff and all(len(ln.split(b"\t")[4]) < 4 for ln in diff)
    got = _run(tcli.main, full, str(d / f"{name}.torch"), device="cpu")
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(want[1]) > 0


@pytest.mark.parametrize("name,args", BEST_CASES,
                         ids=[c[0] for c in BEST_CASES])
def test_cli_best_parity(data, name, args, monkeypatch):
    """The reference side runs its host best-first engine, which its
    device engine equals (tests/test_best_device.py), as the case table's
    rows do: each of its machine configurations is a ~20 s XLA compile."""
    base, reads, d = data
    full = args + [base, reads]
    monkeypatch.setenv("BOWTIE_TPU_HOST_ENGINE", "1")
    want = _run(jcli.main, full, str(d / f"{name}.jax"))
    monkeypatch.delenv("BOWTIE_TPU_HOST_ENGINE")
    got = _run(tcli.main, full, str(d / f"{name}.torch"), device="cpu")
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(want[1]) > 0


def _masked(err):
    """--stats' wall-time line, which differs from run to run, masked."""
    return re.sub(r"wall time: .*", "wall time: -", err)


@pytest.mark.parametrize("name,args", [
    ("sanity_n2", ["-n", "2", "--sanity", "-u", "150"]),
    ("sanity_v1_a", ["-v", "1", "-a", "--sanity", "-u", "150"]),
    ("sanity_v0", ["-v", "0", "-k", "2", "--sanity"]),
    ("stats_n2", ["-n", "2", "--stats", "-u", "200"]),
    ("stats_v0", ["-v", "0", "-a", "--stats"]),
    ("stats_sanity_v2", ["-v", "2", "--stats", "--sanity", "-u", "100"]),
    ("sanity_best_v2_k2", ["-v", "2", "--best", "-k", "2", "--sanity",
                           "-u", "150"]),
    ("stats_v3_a", ["-v", "3", "-a", "--stats", "-u", "150"]),
    ("sanity_n2_strata_a", ["-n", "2", "-a", "--best", "--strata",
                            "--sanity", "-u", "150"])],
    ids=lambda v: v if isinstance(v, str) else None)
def test_cli_sanity_stats_parity(data, name, args, monkeypatch):
    base, reads, d = data
    full = args + [base, reads]
    if name.startswith("sanity_") and "--best" in args:
        # the reference's host best-first engine (its --sanity is then a
        # no-op): only --stats reads its device engine's fallback count
        monkeypatch.setenv("BOWTIE_TPU_HOST_ENGINE", "1")
    want = _run(jcli.main, full, str(d / f"{name}.jax"))
    monkeypatch.delenv("BOWTIE_TPU_HOST_ENGINE", raising=False)
    got = _run(tcli.main, full, str(d / f"{name}.torch"), device="cpu")
    assert got[0] == want[0] == 0
    assert got[1] == want[1] and len(want[1]) > 0
    assert _masked(got[2]) == _masked(want[2])
    assert ("AlignerMetrics:" in want[2]) == ("--stats" in args)
    if name == "stats_v3_a":
        # the best-first machine's host-engine re-runs are counted
        assert re.search(r"fallbacks: [1-9]", want[2])


def test_cli_p_host_engine(data, monkeypatch):
    """-p 2 forks the host best-first engine (ParallelHostAligner) and
    writes what -p 1 writes, and what the reference CLI writes.  No CLI
    path on an index this small builds a host engine, so build_aligner is
    made to return it."""
    base, reads, d = data
    real = tcli.build_aligner
    monkeypatch.setattr(tcli, "build_aligner",
                        lambda args, idx, policy, dev, host_engine=False:
                        real(args, idx, policy, dev, host_engine=True))
    pools = []
    real_pool = tcli.ParallelHostAligner

    def pool(al, n):
        pools.append(n)
        return real_pool(al, n)
    monkeypatch.setattr(tcli, "ParallelHostAligner", pool)
    args = ["-v", "2", "--best", "-k", "2", "-u", "200", base, reads]
    want = _run(jcli.main, args, str(d / "p.jax"))
    one = _run(tcli.main, ["-p", "1"] + args, str(d / "p1.torch"),
               device="cpu")
    two = _run(tcli.main, ["-p", "2"] + args, str(d / "p2.torch"),
               device="cpu")
    assert pools == [2]
    assert one == two == want
    assert len(want[1]) > 0


def test_cli_sanity_raises_on_divergence(data, monkeypatch):
    """A device result that differs from its host twin's raises, naming
    the read; nothing catches it."""
    base, reads, d = data
    real = tcli.build_aligner

    def broken(args, idx, policy, dev, host_engine=False):
        al = real(args, idx, policy, dev, host_engine)
        if host_engine:
            return al
        align = al.align_batch

        def drop_hits(batch):
            res = align(batch)
            res[0].hits = []
            return res
        al.align_batch = drop_hits
        return al
    monkeypatch.setattr(tcli, "build_aligner", broken)
    with pytest.raises(AssertionError, match="divergence on read b'read0"):
        _run(tcli.main, ["-n", "2", "--sanity", "-u", "20", base, reads],
             str(d / "sanity_broken.torch"), device="cpu")


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

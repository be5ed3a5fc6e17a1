"""The port's bowtie-build (bowtie_tpu_torch.cli.build.main on the CPU)
against the JAX package's (bowtie_tpu.cli.build.main): every file it
writes, byte for byte, for each option set on tests/golden/small_genome.fa
(also equal to the committed reference indexes) and on the degenerate
genomes of tests/test_build.py; the blockwise SA chunks against the JAX
ones; and the builder's error paths (a CUDA out-of-memory error is not
the autoMem retry, --jax-sa without a card raises)."""
import os

import numpy as np
import pytest
import torch

from bowtie_tpu.build import blockwise as j_bw
from bowtie_tpu.build import builder as j_builder
from bowtie_tpu.cli import build as j_cli
from bowtie_tpu_torch.build import blockwise as t_bw
from bowtie_tpu_torch.build import builder as t_builder
from bowtie_tpu_torch.build import sa as t_sa
from bowtie_tpu_torch.build.sa import suffix_array
from bowtie_tpu_torch.cli import build as t_cli

HERE = os.path.dirname(__file__)
FASTA = os.path.join(HERE, "golden", "small_genome.fa")
GOLD = os.path.join(HERE, "golden", "small_index", "small_oracle")
GOLD_L = os.path.join(HERE, "golden", "small_index_l", "small_oracle")

# tests/test_build.py EDGE_GENOMES (kept as a copy: that module is the
# JAX package's test and is not imported here)
EDGE_GENOMES = {
    "trailing_n": ">a\nACGTACGTACGTACGTACGTNNNNN\n"
                  ">b\nNNNNACGTACGTACGTACGTACGTGGGG\n",
    "all_n_seq": ">x\nACGTACGTACGTACGTACGT\n>allN\nNNNNNNNN\n"
                 ">y\nTTTTGGGGCCCCAAAATTTT\n",
    "empty_seq": ">e\n\n>x\nACGTACGTACGTACGTACGT\n",
    "leading_all_n": ">nstart\nNNNN\n>x\nACGTACGTACGTACGTACGT\n",
}

# (id, flags): bowtie-build's option surface, as tests/test_build.py
# holds the JAX builder to the reference binary
SMALL_FLAGS = [
    ("default", []),
    ("jax_sa", ["--jax-sa"]),
    ("ntoa", ["--ntoa"]),
    ("justref", ["-3"]),
    ("noref", ["-r"]),
    ("big", ["--big"]),
    ("norev", ["--norev"]),
    ("large", ["--large-index"]),
    ("new_reverse", ["--new-reverse"]),
    ("o3_t8", ["-o", "3", "-t", "8"]),
    ("blockwise_bmax", ["--bmax", "2048", "--dcv", "256"]),
    ("blockwise_divn", ["--bmaxdivn", "8", "--dcv", "128"]),
    ("blockwise_large", ["--bmax", "4000", "--dcv", "512",
                         "--large-index", "--new-reverse"]),
]
EDGE_FLAGS = [
    ("default", []),
    ("ntoa_large", ["--ntoa", "--large-index"]),
    ("new_reverse_big", ["--new-reverse", "--big"]),
    ("jax_sa", ["--jax-sa", "-t", "3"]),
]


def _build_both(tmp_path, flags, fasta):
    """Run both CLIs with `flags` on `fasta`; -> {name: bytes} of what
    each wrote."""
    out = []
    for tag, main, kw in (("jax", j_cli.main, {}),
                          ("torch", t_cli.main, {"device": "cpu"})):
        d = tmp_path / tag
        d.mkdir()
        assert main([*flags, "-q", fasta, str(d / "idx")], **kw) == 0
        out.append({p: (d / p).read_bytes() for p in os.listdir(d)})
    return out


def _counting(monkeypatch, module, name):
    """Wrap module.name so that its calls are counted."""
    calls = []
    real = getattr(module, name)

    def wrapper(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("flags", [f for _, f in SMALL_FLAGS],
                         ids=[i for i, _ in SMALL_FLAGS])
def test_cli_build_small_genome(tmp_path, flags, monkeypatch):
    rounds = _counting(monkeypatch, t_sa, "sa_round")
    chunked = _counting(monkeypatch, t_bw, "blockwise_sa_chunks")
    want, got = _build_both(tmp_path, [*flags, "-o", "5", "-t", "7"]
                            if "-o" not in flags else flags, FASTA)
    # the route each flag set selects: the doubling rounds only under
    # --jax-sa, the blockwise chunks (fw and mirror) under --bmax/--bmaxdivn
    blockwise = "--bmax" in flags or "--bmaxdivn" in flags
    assert (len(rounds) > 0) == ("--jax-sa" in flags)
    assert len(chunked) == (2 if blockwise else 0)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    # the committed reference indexes of this genome (-o 5 -t 7)
    if flags in ([], ["--jax-sa"]):
        gold = GOLD
    elif flags == ["--large-index"]:
        gold = GOLD_L
    else:
        return
    assert len(got) == 6
    for name, data in got.items():
        with open(gold + name[len("idx"):], "rb") as f:
            assert data == f.read(), name


@pytest.mark.parametrize("flags", [f for _, f in EDGE_FLAGS],
                         ids=[i for i, _ in EDGE_FLAGS])
@pytest.mark.parametrize("genome", sorted(EDGE_GENOMES))
def test_cli_build_edge_genomes(tmp_path, genome, flags):
    fa = tmp_path / "g.fa"
    fa.write_text(EDGE_GENOMES[genome])
    want, got = _build_both(tmp_path, flags, str(fa))
    assert sorted(got) == sorted(want) and len(got) == 6
    for name in want:
        assert got[name] == want[name], name


def test_cli_build_cmdline_sequences(tmp_path):
    """-c: the sequences are the argument itself (names 0, 1, ...)."""
    seqs = "ACGTTGCAAGGCTTACGATC" * 20 + ",GGGTTTAACCNNNACGTAGCATG"
    out = []
    for tag, main, kw in (("jax", j_cli.main, {}),
                          ("torch", t_cli.main, {"device": "cpu"})):
        base = str(tmp_path / tag)
        assert main(["-c", "-q", "-t", "5", seqs, base], **kw) == 0
        out.append([open(base + e, "rb").read() for e in
                    (".1.ebwt", ".2.ebwt", ".3.ebwt", ".4.ebwt",
                     ".rev.1.ebwt", ".rev.2.ebwt")])
    assert out[0] == out[1]


def _texts():
    rng = np.random.default_rng(11)
    rand = rng.integers(0, 4, 3000).astype(np.uint8)
    rep = rng.integers(0, 4, 3000).astype(np.uint8)
    seg = rng.integers(0, 4, 300).astype(np.uint8)
    for s in (100, 1100, 2100):
        rep[s:s + 300] = seg
    return {"random": rand, "repeats": rep,
            "period": np.tile(np.array([0, 1, 1, 3], np.uint8), 700)}


@pytest.mark.parametrize("name", ["random", "repeats", "period"])
def test_blockwise_sa_chunks_equal_jax(name):
    codes = _texts()[name]
    kw = dict(bmax=500, dcv=64)
    t_chunks = list(t_bw.blockwise_sa_chunks(codes, **kw))
    j_chunks = list(j_bw.blockwise_sa_chunks(codes, **kw))
    assert len(t_chunks) == len(j_chunks)
    for a, b in zip(t_chunks, j_chunks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(t_chunks),
                                  suffix_array(codes))
    np.testing.assert_array_equal(
        t_bw.suffix_array_blockwise(codes, bmax=500, dcv=64),
        j_bw.suffix_array_blockwise(codes, bmax=500, dcv=64))


def test_difference_cover_and_sample_equal_jax():
    for v in (16, 64, 256):
        np.testing.assert_array_equal(t_bw.difference_cover(v),
                                      j_bw.difference_cover(v))
    codes = _texts()["repeats"]
    ts = t_bw.DCSample(t_bw.PackedText(codes), 64)
    js = j_bw.DCSample(j_bw.PackedText(codes), 64)
    np.testing.assert_array_equal(ts.rank, js.rank)
    np.testing.assert_array_equal(ts.delta, js.delta)


def test_reverse_records_and_rstarts_equal_jax():
    seqs = [np.array([4, 4, 0, 1, 4, 2, 3, 4], np.uint8),
            np.full(5, 4, np.uint8), np.array([3, 3, 4, 0], np.uint8)]
    recs, _ = t_builder.fasta_to_records(seqs)
    assert recs == j_builder.fasta_to_records(seqs)[0]
    rrec = t_builder.reverse_ref_records(recs)
    assert rrec == j_builder.reverse_ref_records(recs)
    plen = np.array([8, 4], np.uint32)
    for osz in (4, 8):
        a = t_builder.szs_rstarts(rrec, plen, 2, True, off_size=osz)
        b = j_builder.szs_rstarts(rrec, plen, 2, True, off_size=osz)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_memory_error_takes_blockwise_route(tmp_path):
    """autoMem: a MemoryError of the in-memory route retries on the
    blockwise route, in both packages, with the same bytes; with
    auto_mem=False it propagates."""
    codes = _texts()["repeats"]

    def no_memory(_s):
        raise MemoryError

    for tag, build in (("jax", j_builder.build_index),
                       ("torch", t_builder.build_index)):
        build([codes], ["r"], str(tmp_path / tag), sa_fn=no_memory,
              dcv=64, ftab_chars=5)
    for ext in (".1.ebwt", ".2.ebwt", ".rev.1.ebwt", ".rev.2.ebwt"):
        assert ((tmp_path / ("torch" + ext)).read_bytes()
                == (tmp_path / ("jax" + ext)).read_bytes()), ext
    with pytest.raises(MemoryError):
        t_builder.build_index([codes], ["r"], str(tmp_path / "x"),
                              sa_fn=no_memory, dcv=64, auto_mem=False)


def test_cuda_out_of_memory_is_not_retried(tmp_path, monkeypatch):
    """A CUDA out-of-memory error of the device SA raises as it is: it
    is not a MemoryError, so autoMem does not turn it into a blockwise
    build."""
    calls = []

    def oom(_s):
        calls.append(1)
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(t_builder, "build_one_streaming",
                        lambda *a, **k: pytest.fail("blockwise retry"))
    with pytest.raises(torch.OutOfMemoryError):
        t_builder.build_index([_texts()["random"]], ["r"],
                              str(tmp_path / "o"), sa_fn=oom, dcv=64)
    assert calls == [1]


def test_jax_sa_needs_a_card(tmp_path, monkeypatch):
    """--jax-sa resolves the device: without CUDA it raises unless the
    caller asks for the CPU; without --jax-sa no device is resolved."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(["--jax-sa", "-q", FASTA, str(tmp_path / "a")])
    assert t_cli.main(["-q", "-t", "5", FASTA, str(tmp_path / "b")]) == 0
    assert t_cli.main(["--jax-sa", "-q", "-t", "5", FASTA,
                       str(tmp_path / "c")], device="cpu") == 0
    assert ((tmp_path / "b.1.ebwt").read_bytes()
            == (tmp_path / "c.1.ebwt").read_bytes())


def test_unsupported_side_geometry_exits_1(tmp_path, capsys):
    assert t_cli.main(["-l", "8", FASTA, str(tmp_path / "x")]) == 1
    assert "side geometries" in capsys.readouterr().err


def test_launchers(tmp_path):
    """bin/bowtie-tpu-torch-build builds on the host without a card,
    refuses --jax-sa without one (naming CUDA), and
    bin/bowtie-tpu-torch-inspect reads back what it built."""
    import subprocess
    import sys
    repo = os.path.dirname(HERE)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}

    def run(tool, *args):
        return subprocess.run(
            [sys.executable, os.path.join(repo, "bin", tool), *args],
            capture_output=True, text=True, timeout=300, env=env)

    base = str(tmp_path / "l")
    p = run("bowtie-tpu-torch-build", "-q", "-o", "5", "-t", "7", FASTA,
            base)
    assert p.returncode == 0, p.stderr
    assert open(base + ".1.ebwt", "rb").read() == \
        open(GOLD + ".1.ebwt", "rb").read()
    p = run("bowtie-tpu-torch-build", "--jax-sa", FASTA,
            str(tmp_path / "j"))
    assert p.returncode != 0 and "CUDA" in p.stderr
    p = run("bowtie-tpu-torch-inspect", "-n", base)
    assert p.returncode == 0
    assert p.stdout.splitlines() == ["seq0 test sequence 0",
                                     "seq1 test sequence 1",
                                     "seq2 test sequence 2"]

"""The paired rows of the declarative case table of
tests/test_simple_cases.py through both CLIs: the port's (on the CPU) against
bowtie_tpu.cli.align.main, on an index built by the port's builder from
that table's genome.  The hits file, every --al/--un/--max dump (the
_1/_2 files of a pair, which files exist) and the stderr summary must be
byte-identical (@PG aside).

This module holds the rows the port sends to its paired host engines:
--reportse (V2) and --nofw/--norc without --best or --pev2 (V1);
tests/test_torch_pe_recorded.py holds the rows that run the V1 engine
over streams recorded by the plain K10r, and tests/test_torch_pev2_cases.py
the --best and --pev2 rows, which run the V2 engine over merged streams
recorded by the plain K14.  The reference side runs its host paired engines, which is what its
CLI picks on a CPU backend (bowtie_tpu/cli/align.py:500-507), and its host
single-end engines for the unpaired records of a --12 file
(BOWTIE_TPU_HOST_ENGINE=1, as tests/test_torch_cases.py does)."""
import gzip
import os

import pytest

from bowtie_tpu.cli import align as jcli
from bowtie_tpu_torch.build.builder import build_from_fasta
from bowtie_tpu_torch.cli import align as tcli
from test_simple_cases import (CASES, GENOME, _expand, _interleaved_text,
                               _pe_fq, _tabbed_mixed_text, _tabbed_text)
from test_torch_cases import _run, _tree_no_pg

PE_KINDS = {"pe", "tabmix", "il", "tab", "pe2", "pegz"}
PE_ROWS = [c for c in CASES if c[1] in PE_KINDS]
V2_FLAGS = {"--best", "--pev2"}
HOST_FLAGS = {"--nofw", "--norc"}


def on_v2_engine(case_args) -> bool:
    """Whether the port runs the row's pairs on the V2 engine."""
    return bool(V2_FLAGS & set(case_args))


def on_host_engine(case_args) -> bool:
    """Whether the port runs the row's pairs on a host engine: V2 under
    --reportse, V1 under --nofw/--norc."""
    if on_v2_engine(case_args):
        return "--reportse" in case_args
    return bool(HOST_FLAGS & set(case_args))


ROWS = [c for c in PE_ROWS if on_host_engine(c[2])]


def make_pe_env(d):
    """The table's paired inputs (tests/test_simple_cases.py env) with the
    index built by the port's builder."""
    fa = d / "genome.fa"
    with open(fa, "w") as f:
        for nm, seq in GENOME:
            f.write(f">{nm}\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + "\n")
    base = str(d / "idx")
    build_from_fasta([str(fa)], base)
    files = {}
    for key, text in (("tab", _tabbed_text()),
                      ("tabmix", _tabbed_mixed_text()),
                      ("il", _interleaved_text())):
        (d / f"in_{key}.txt").write_text(text)
        files[key] = ("PE", str(d / f"in_{key}.txt"))
    for which in (1, 2):
        txt = _pe_fq(which)
        (d / f"pe_{which}.fq").write_text(txt)
        files[f"pe{which}"] = ("PE", str(d / f"pe_{which}.fq"))
        with gzip.open(d / f"pe_{which}.fq.gz", "wt") as f:
            f.write(txt)
        files[f"pe{which}gz"] = ("PE", str(d / f"pe_{which}.fq.gz"))
        lines = txt.splitlines(keepends=True)
        h = (len(lines) // 8 // 2) * 4
        (d / f"pe{which}_a.fq").write_text("".join(lines[:h]))
        (d / f"pe{which}_b.fq").write_text("".join(lines[h:]))
        files[f"pe{which}x2"] = ("PE", f"{d}/pe{which}_a.fq,"
                                       f"{d}/pe{which}_b.fq")
    return {"base": base, "genome": str(fa), "files": files}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return make_pe_env(tmp_path_factory.mktemp("torch_pe_cases"))


def case_parity(case_args, infmt, env, tmp_path, monkeypatch):
    """Run one row through both CLIs and compare every artifact."""
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


@pytest.mark.parametrize("cid,infmt,case_args", ROWS,
                         ids=[c[0] for c in ROWS])
def test_pe_case_parity(cid, infmt, case_args, env, tmp_path, monkeypatch):
    case_parity(case_args, infmt, env, tmp_path, monkeypatch)


def test_pe_rows_cover_the_table():
    """The 57 paired rows of the table, split between this module,
    tests/test_torch_pe_recorded.py and tests/test_torch_pev2_cases.py,
    together with the single-end rows of tests/test_torch_cases.py take
    every row."""
    from test_torch_cases import ROWS as SE_ROWS
    from test_torch_pe_recorded import ROWS as REC_ROWS
    from test_torch_pev2_cases import ROWS as V2_ROWS
    assert len(PE_ROWS) == 57
    assert len(ROWS) + len(REC_ROWS) + len(V2_ROWS) == 57
    names = [c[0] for c in ROWS + REC_ROWS + V2_ROWS]
    assert len(set(names)) == 57
    assert len(SE_ROWS) + len(PE_ROWS) == len(CASES)

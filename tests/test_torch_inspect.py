"""The port's bowtie-inspect (bowtie_tpu_torch.cli.inspect.main) against
the JAX package's (bowtie_tpu.cli.inspect.main): what each prints, line
for line, in every mode, on the committed small and large indexes and on
a built multi-record index with Ns; and the index reader's occ
checkpoints and embedded occ counters against the JAX ones."""
import contextlib
import io
import os

import numpy as np
import pytest

from bowtie_tpu.build import builder as j_builder
from bowtie_tpu.cli import inspect as j_cli
from bowtie_tpu.index import ebwt_io as j_io
from bowtie_tpu_torch.build.inspect import restore_via_lf
from bowtie_tpu_torch.cli import inspect as t_cli
from bowtie_tpu_torch.index import ebwt_io as t_io

HERE = os.path.dirname(__file__)
GOLD = os.path.join(HERE, "golden", "small_index", "small_oracle")
GOLD_L = os.path.join(HERE, "golden", "small_index_l", "small_oracle")

MODES = {"default": [], "names": ["-n"], "summary": ["-s"],
         "summary_extra": ["-s", "--extra"], "ebwt": ["-e"],
         "across40": ["-a", "40"]}
# bowtie_tpu's inspect opens `.3.ebwt` only, so beside an .ebwtl index
# these modes raise there (ROADMAP, queue 3); the port reads `.3.ebwtl`
# as bowtie does, and is held to the JAX output of the small index of the
# same genome
NEEDS_REF_FILES = {"default", "summary_extra", "across40"}


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    """A built index of four records with N runs, an all-N record and
    a trailing gap."""
    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 4, 700).astype(np.uint8),
            np.full(30, 4, np.uint8),
            rng.integers(0, 4, 450).astype(np.uint8),
            rng.integers(0, 4, 260).astype(np.uint8)]
    seqs[0][100:140] = 4
    seqs[0][500:503] = 4
    seqs[2][:12] = 4
    seqs[3][-20:] = 4
    base = str(tmp_path_factory.mktemp("multi") / "m")
    j_builder.build_index(seqs, ["r0 first", "allN", "r2", "r3 tail"],
                          base, ftab_chars=6, off_rate=3)
    return base


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("index", ["small", "large", "multi"])
def test_cli_inspect_equals_jax(index, mode, multi):
    base = {"small": GOLD, "large": GOLD_L, "multi": multi}[index]
    got = _run(t_cli.main, [*MODES[mode], base])
    ref = GOLD if index == "large" and mode in NEEDS_REF_FILES else base
    want = _run(j_cli.main, [*MODES[mode], ref])
    assert got.splitlines() == want.splitlines()
    assert got == want


def test_jax_inspect_misses_large_reference():
    """The reference fault the large-index cases above step around."""
    with pytest.raises(FileNotFoundError):
        _run(j_cli.main, [GOLD_L])


@pytest.mark.parametrize("index", ["small", "large", "multi"])
def test_occ_checkpoints_and_restore_equal_jax(index, multi):
    base = {"small": GOLD, "large": GOLD_L, "multi": multi}[index]
    for b in (base, base + ".rev"):
        j, t = j_io.read_ebwt(b), t_io.read_ebwt(b)
        a, c = j.occ_checkpoints(), t.occ_checkpoints()
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(a, c)
        assert t.occ_checkpoints() is c          # cached
        from bowtie_tpu.build.inspect import restore_via_lf as j_restore
        np.testing.assert_array_equal(restore_via_lf(t), j_restore(j))


@pytest.mark.parametrize("index", ["small", "multi"])
def test_read_embedded_occ_equal_jax(index, multi):
    base = {"small": GOLD, "multi": multi}[index]
    for b in (base, base + ".rev"):
        a, c = j_io.read_embedded_occ(b), t_io.read_embedded_occ(b)
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(a, c)
        # the embedded counters agree with the recomputed checkpoints at
        # each side pair's boundary (rows 224 + p*448, '$' not an A)
        idx = t_io.read_ebwt(b, load_offs=False)
        rows = 224 + 448 * np.arange(len(c))
        inside = rows <= idx.bwt_len
        full = np.zeros((idx.bwt_len + 449, 4), np.int64)
        for ch in range(4):
            np.cumsum(np.pad(idx.bwt, (0, 448)) == ch, out=full[1:, ch])
        want = full[rows[inside]]
        want[:, 0] -= rows[inside] > idx.zoff
        np.testing.assert_array_equal(c[inside], want)


def test_large_reference_files_read():
    """.3.ebwtl/.4.ebwtl hold the records and bases of .3.ebwt/.4.ebwt."""
    a = t_io.read_bitpair_reference(GOLD)
    b = t_io.read_bitpair_reference(GOLD_L)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])

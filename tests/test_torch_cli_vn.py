"""CLI parity of -v 1/-v 2 (the DFS machine) and -n (bowtie's default
seeded mode): the PyTorch port (on the CPU) against
bowtie_tpu.cli.align.main, byte for byte — hits file and stderr summary —
on the index of tests/torch_cli_common.py."""
import pytest

from bowtie_tpu.cli import align as jcli
from bowtie_tpu_torch.cli import align as tcli

from torch_cli_common import _run, data  # noqa: F401  (data: a fixture)

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

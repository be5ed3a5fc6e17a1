"""K16's plain version (build/sa.py sa_round_plain) against the JAX
package's prefix-doubling round (bowtie_tpu/build/sa.py round_fn, inside
suffix_array_jax), round for round on the same ranks and step, and the
port's whole doubling SA against suffix_array_jax, _suffix_array_doubling
and SA-IS.  Exact equality throughout.  round_fn closes over n, so each
call of suffix_array_jax compiles anew: the JAX side runs only at the few
small sizes below."""
import numpy as np
import pytest
import torch

import jax

from bowtie_tpu.build import sa as j_sa
from bowtie_tpu_torch.build import sa as t_sa

SIZES = [1, 2, 33, 50, 1000]
REPETITIVE = {
    "all_a": np.zeros(1000, np.uint8),
    "period3": np.tile(np.array([0, 1, 2], np.uint8), 334)[:1000],
    "planted": None,            # a random text with 8 copies of 40 bases
}


def _text(kind, n=None):
    rng = np.random.default_rng(8 if n is None else n)
    if kind == "random":
        return rng.integers(0, 4, n).astype(np.uint8)
    if kind == "planted":
        t = rng.integers(0, 4, 1000).astype(np.uint8)
        seg = rng.integers(0, 4, 40).astype(np.uint8)
        for s in range(0, 960, 120):
            t[s:s + 40] = seg
        return t
    return REPETITIVE[kind]


CASES = [("random", n) for n in SIZES] + [(k, None) for k in REPETITIVE]
IDS = [f"{k}{n or ''}" for k, n in CASES]


def _jax_rounds(codes, monkeypatch):
    """suffix_array_jax(codes), recording every round_fn call's inputs
    and outputs as numpy arrays."""
    calls = []
    real_jit = jax.jit

    def recording_jit(fn):
        jitted = real_jit(fn)

        def run(r, k):
            out = jitted(r, k)
            calls.append((np.array(r), int(k),
                          tuple(np.asarray(o) for o in out)))
            return out
        return run

    monkeypatch.setattr(jax, "jit", recording_jit)
    sa = j_sa.suffix_array_jax(codes)
    monkeypatch.setattr(jax, "jit", real_jit)
    return sa, calls


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_sa_round_plain_equals_jax_round(kind, n, monkeypatch):
    codes = _text(kind, n)
    sa_jax, calls = _jax_rounds(codes, monkeypatch)
    r0, big = t_sa.initial_ranks(codes)
    assert big == max(len(codes) + 2, 6)
    np.testing.assert_array_equal(calls[0][0], r0)
    for r, k, (nr, order, maxg) in calls:
        t_nr, t_order, t_maxg = t_sa.sa_round_plain(torch.from_numpy(r), k,
                                                    big)
        assert t_nr.dtype == t_order.dtype == t_maxg.dtype == torch.int32
        np.testing.assert_array_equal(t_nr.numpy(), nr)
        np.testing.assert_array_equal(t_order.numpy(), order)
        assert int(t_maxg) == int(maxg)
    # the port's doubling SA: the same rounds, the same SA as every
    # reference route
    sa = t_sa.suffix_array_doubling(codes, device="cpu")
    assert sa.dtype == np.int64
    np.testing.assert_array_equal(sa, sa_jax)
    np.testing.assert_array_equal(sa, j_sa._suffix_array_doubling(codes))
    np.testing.assert_array_equal(sa, j_sa.suffix_array(codes))
    np.testing.assert_array_equal(sa, t_sa.suffix_array(codes))


@pytest.mark.parametrize("n", [0, 1, 7, 4096, 20000])
def test_doubling_equals_sais_without_jax(n):
    """Sizes the JAX side is not compiled for: the empty text, one
    tile's edge, several tiles; random and all-A."""
    rng = np.random.default_rng(n)
    for codes in (rng.integers(0, 4, n).astype(np.uint8),
                  np.full(n, 3, np.uint8)):
        np.testing.assert_array_equal(
            t_sa.suffix_array_doubling(codes, device="cpu"),
            t_sa.suffix_array(codes))


def test_sa_round_plain_step_past_end():
    """k = n+1 (the loop's min(k, n+1)): every extension rank is BIG."""
    r = torch.tensor([2, 1, 2, 1, 7], dtype=torch.int32)
    nr, order, maxg = t_sa.sa_round_plain(r, 5, 7)
    assert order.tolist() == [1, 3, 0, 2, 4]
    assert nr.tolist() == [1, 0, 1, 0, 2]
    assert int(maxg) == 2


def test_doubling_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sa.suffix_array_doubling(np.zeros(10, np.uint8))


def test_doubling_refuses_oversized_text():
    class Huge:
        def __len__(self):
            return 2**31 - 2
    with pytest.raises(ValueError, match="2\\*\\*31"):
        t_sa.suffix_array_doubling(Huge(), device="cpu")

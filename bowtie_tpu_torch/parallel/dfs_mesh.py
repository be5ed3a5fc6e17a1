"""The DFS machine (-v 1/2, the -n launches) with its lanes split across
a list of devices.

A port of bowtie_tpu/parallel/dfs_mesh.py.  The reference replicates the
fw + mirror index pair (FMCat) over a JAX mesh and lets GSPMD partition
one jitted while loop over the lane-sharded inputs; its only exchange is
the loop's termination reduce.  Here each device gets one copy of the
FMPair, the lanes are split into one contiguous chunk per mesh entry, and
each chunk runs K6 (derive_rows, where the jobs come without rows) and K7
(run_machine) on its own device: the lanes are independent, so a lane's
result does not depend on its shard, and the chunks' outputs are
concatenated in lane order.  The iteration count is the largest of any
shard's.  The kernel counts each lane's own transitions, so that is the
count of one launch over all lanes.  The plain version counts lockstep
iterations, whose batch-wide sub-step gates can make a shard alone take
an iteration more than the whole batch (tests/test_torch_dfs_mesh.py);
the reference's one sharded loop counts the whole batch's.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..align import dfs_device as D
from .mesh import index_to, make_mesh


def make_dp_mesh(devices=None) -> list[torch.device]:
    """The data-parallel mesh: `devices`, or every CUDA device."""
    return make_mesh(devices)


def pair_to(pair: D.FMPair, device) -> D.FMPair:
    """The index pair on `device` (the pair itself when it is there)."""
    device = torch.device(device)
    if pair.device == device:
        return pair
    return D.FMPair(fw=index_to(pair.fw, device),
                    bw=index_to(pair.bw, device),
                    rstarts=pair.rstarts.to(device), length=pair.length,
                    dense=pair.dense)


def replicate_cat(pair: D.FMPair, mesh) -> dict:
    """One copy of the fw + mirror pair per distinct device of the mesh,
    keyed by device (the reference's replicated FMCat)."""
    return {d: pair_to(pair, d) for d in dict.fromkeys(mesh)}


def shard_lanes(mesh, *arrays) -> list[tuple]:
    """Per-lane arrays (numpy or torch, lanes on axis 0) split into one
    contiguous chunk per mesh entry, each on its device: [(chunk of each
    array) per entry].  The lane count must divide by the mesh size
    (ValueError otherwise); callers pad to it (dfs_mesh.py:54)."""
    n = len(mesh)
    B = arrays[0].shape[0]
    if B % n:
        raise ValueError(f"lane count {B} not divisible by {n}")
    per = B // n
    ts = [torch.as_tensor(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a for a in arrays]
    return [tuple(t[i * per:(i + 1) * per].to(d) for t in ts)
            for i, d in enumerate(mesh)]


def run_sharded(pair: D.FMPair, jobs_np: dict, seeds, count0, mesh, *,
                n_k: int, m_max: int, max_steps: int):
    """Run the DFS machine with its lanes split over the mesh.  jobs_np:
    a host job table as align/dfs_jobs.py builds it (per-field [B, J]
    arrays plus base_codes, base_qual, base_plen; each shard's rows are
    derived on its device by K6), or one with its rows derived already
    ({"scal", "qqp"}, as upload_jobs gives it); seeds: [B] uint32 values;
    count0: [B] int32.  -> (outputs by OUT_KEYS over all lanes, in lane
    order on the first entry's device; the most iterations any shard
    took)."""
    n = len(mesh)
    B = len(seeds)
    pairs = replicate_cat(pair, mesh)
    seeds = np.asarray(seeds).astype(np.int64)
    count0 = np.asarray(count0, np.int32)
    derived = "scal" in jobs_np and "qqp" in jobs_np
    keys = (("scal", "qqp") if derived
            else tuple(D.JOB_FIELDS) + ("base_codes", "base_qual",
                                        "base_plen"))
    per = B // n
    outs, iters = [], []
    for i, (d, (sd, c0)) in enumerate(zip(mesh, shard_lanes(mesh, seeds,
                                                            count0))):
        tab = {k: jobs_np[k][i * per:(i + 1) * per] for k in keys}
        with (torch.cuda.device(d) if d.type == "cuda"
              else contextlib.nullcontext()):
            jobs = ({k: torch.as_tensor(v).to(d) for k, v in tab.items()}
                    if derived else D.upload_jobs(tab, pair.ftab_chars, d))
            out, it = D.run_machine(pairs[d], jobs, sd, c0, n_k=n_k,
                                    m_max=m_max, max_steps=max_steps)
        outs.append(out)
        iters.append(int(it))
    home = mesh[0]
    return ({k: torch.cat([o[k].to(home) for o in outs])
             for k in outs[0]}, max(iters))

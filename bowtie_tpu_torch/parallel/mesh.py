"""Data-parallel exact alignment over a list of devices: a replicated
index, reads split by batch.

A port of bowtie_tpu/parallel/mesh.py.  The reference replicates the
index over a JAX mesh and lets XLA partition one jit over the sharded
reads.  Here a mesh is a list of torch devices (an entry may repeat: the
shards then share that device and its one copy of the index), the index
is copied once per distinct device, the batch is split into one
contiguous chunk per entry, and each chunk is one launch of K15 on its
device's stream.  The search needs no exchange between devices; the
outputs are gathered on the first entry's device in shard order, so they
keep the read order.

Kernel, with a wrapper that launches it on CUDA tensors and runs its
plain PyTorch version (in this module) on CPU tensors:

  K15 align_step <- mesh.py:55 sharded_align_step: K2's backward search
                    of each right-aligned strand and K3's resolve of the
                    top row of each non-empty range, fused in one thread
                    per strand (csrc/exact.cu align_step_kernel)
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import kernels
from ..align.exact import exact_ranges_plain, resolve_rows_plain, walk_ptr
from ..index.arrays import U32, FMIndexArrays
from ..utils.device import resolve_device


def make_mesh(devices=None) -> list[torch.device]:
    """The mesh: `devices` as torch devices, or every CUDA device (raises
    when there is none, as every entry point does)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    mesh = [_indexed(resolve_device(d)) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _indexed(d: torch.device) -> torch.device:
    """A CUDA device with its ordinal ("cuda" -> the current one), as the
    device of a tensor on it reads."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def index_to(fm: FMIndexArrays, device) -> FMIndexArrays:
    """fm's arrays on `device` (fm itself when they are there already)."""
    device = torch.device(device)
    if fm.device == device:
        return fm
    moved = {f.name: getattr(fm, f.name).to(device)
             for f in dataclasses.fields(fm)
             if isinstance(getattr(fm, f.name), torch.Tensor)}
    return dataclasses.replace(fm, kernel_view=None, **moved)


def replicate_index(fm: FMIndexArrays, mesh) -> dict:
    """One copy of the index per distinct device of the mesh, keyed by
    device."""
    return {d: index_to(fm, d) for d in dict.fromkeys(mesh)}


def shard_reads(mesh, reads, lens):
    """Pad the batch to a multiple of the mesh size with rows of code 4
    and length 0 (mesh.py:40-51), split it into one contiguous chunk per
    mesh entry, each on its device.  reads uint8 [B, L], lens int32 [B]
    (host arrays) -> ([(reads, lens) per entry], B)."""
    reads = torch.as_tensor(np.asarray(reads, np.uint8))
    lens = torch.as_tensor(np.asarray(lens, np.int32))
    n = len(mesh)
    B = reads.shape[0]
    pad = (-B) % n
    if pad:
        reads = torch.cat([reads, reads.new_full((pad, reads.shape[1]), 4)])
        lens = torch.cat([lens, lens.new_zeros(pad)])
    per = reads.shape[0] // n
    return ([(reads[i * per:(i + 1) * per].to(d),
              lens[i * per:(i + 1) * per].to(d)) for i, d in enumerate(mesh)],
            B)


def align_step_plain(fm: FMIndexArrays, reads: torch.Tensor,
                     lens: torch.Tensor):
    """K15's plain version: exact_ranges_plain, then resolve_rows_plain of
    the top row where the range is not empty, with mesh.py:62-67's masks.
    -> (top, bot, off, ok): int64 [B] x 3 ((0, 0) and the all-ones uint32
    sentinel where there is no range), bool [B] (False there)."""
    top, bot = exact_ranges_plain(fm, reads, lens)
    has = bot > top
    off, ok = resolve_rows_plain(fm, torch.where(has, top, 0))
    return top, bot, torch.where(has, off, U32), ok & has


def align_step(fm: FMIndexArrays, reads: torch.Tensor, lens: torch.Tensor):
    """K15: align_step_plain's outputs for the right-aligned uint8 reads
    [B, L] with int32 lengths [B], in one launch of csrc/exact.cu's
    align_step_kernel on CUDA tensors."""
    if kernels.on_cpu(fm, reads, lens):
        return align_step_plain(fm, reads, lens)
    dev = fm.device
    kernels.check(reads, "reads", torch.uint8, 2, dev)
    kernels.check(lens, "lens", torch.int32, 1, dev)
    n, L = reads.shape
    if lens.shape[0] != n:
        raise ValueError(f"lens has {lens.shape[0]} entries for {n} reads")
    top, bot, off = (torch.empty(n, dtype=torch.int64, device=dev)
                     for _ in range(3))
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        kernels.launch("align_step", "bt_align_step", kernels.fm_view(fm),
                       walk_ptr(fm), reads.data_ptr(), lens.data_ptr(), n, L,
                       int(fm.sa is not None), top.data_ptr(),
                       bot.data_ptr(), off.data_ptr(), ok.data_ptr(),
                       device=dev)
    return top, bot, off, ok


def sharded_align_step(fm_by_device: dict, shards: list):
    """K15 over the shards of shard_reads: one align_step per shard, each
    on its own device with that device current (so on its stream), then
    the outputs concatenated in shard order on the first shard's device.
    -> (top, bot, off, ok) over the padded batch, as align_step gives
    them."""
    outs = []
    for reads, lens in shards:
        dev = reads.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            outs.append(align_step(fm_by_device[dev], reads, lens))
    home = shards[0][0].device
    return tuple(torch.cat([o[k].to(home) for o in outs])
                 for k in range(4))


"""Run a function on a few CPU processes joined by a gloo process group.

The port's distributed layers take a ``torch.distributed`` group; their
CPU tests run one process a rank, as the card would run one a GPU.
``run_ranks(fn, world, tmp_path, *args)`` spawns ``world`` processes,
each calling ``fn(group, *args)`` with the group of all of them, and
returns their results in rank order. The group is created through a file
under ``tmp_path`` (no TCP port to collide between test workers) with a
60 s collective timeout, and the processes are joined with a deadline:
a missed deadline or a failed rank fails the test instead of hanging it.

This module and everything a rank runs import only ``torch``, ``numpy``
and the port: spawned processes re-import it, and JAX stays in the test
process.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

__all__ = ["run_ranks", "moe_rank", "ring_rank"]


def _rank_main(rank, world, init_file, out_dir, fn, args):
    import torch
    import torch.distributed as dist
    out = Path(out_dir) / f"rank{rank}.pkl"
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        try:
            res = fn(dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        out.write_bytes(pickle.dumps(("ok", res)))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise


def run_ranks(fn, world, tmp_path, *args, timeout=120.0):
    """``[fn(group, *args) on rank r for r in range(world)]``; raises
    ``RuntimeError`` when a rank fails or the deadline passes."""
    ctx = mp.get_context("spawn")
    out_dir = Path(tmp_path) / f"ranks-{fn.__name__}-{time.monotonic_ns()}"
    out_dir.mkdir(parents=True)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(out_dir / "init"), str(out_dir),
                               fn, args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise RuntimeError(f"ranks {late} missed the {timeout:.0f} s "
                               f"deadline")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for r, p in enumerate(procs):
        f = out_dir / f"rank{r}.pkl"
        if not f.is_file():
            raise RuntimeError(f"rank {r} exited {p.exitcode} with no result")
        status, res = pickle.loads(f.read_bytes())
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{res}")
        results.append(res)
    return results


def moe_rank(group, x, wr, w1, w2, cases):
    """This rank's MoE layer output on its token shard, for each
    ``(top_k, capacity_factor, use_tile_kernel, repeats)`` case, plus
    the shards it was given."""
    from tilelang_mesh_tpu_torch.parallel import moe
    xs = moe.shard_rows(x, group, device="cpu")
    wr_t, w1s, w2s = moe.weights_from_numpy(wr, w1, w2, group, device="cpu")
    outs = []
    for top_k, cf, tile, repeats in cases:
        layer = moe.make_moe_layer(group, top_k=top_k, capacity_factor=cf,
                                   use_tile_kernel=tile)
        outs.append([layer(xs, wr_t, w1s, w2s).numpy()
                     for _ in range(repeats)])
    return {"outs": outs, "x": xs.numpy(), "w1": w1s.numpy(),
            "w2": w2s.numpy(), "wr": wr_t.numpy()}


def ring_rank(group, q, k, v, causals):
    """This rank's ring attention output on its sequence shard, for each
    causal flag."""
    import torch
    from tilelang_mesh_tpu_torch.parallel import (axis_index, axis_size,
                                                  make_ring_attention)
    P, r = axis_size(group), axis_index(group)
    n = q.shape[2] // P
    q, k, v = (torch.from_numpy(np.ascontiguousarray(t[:, :, r * n:(r + 1)
                                                         * n]))
               for t in (q, k, v))
    return [make_ring_attention(group, causal=c)(q, k, v).numpy()
            for c in causals]

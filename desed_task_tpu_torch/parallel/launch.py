"""Run a function on several ranks, each a new process, with a deadline.

`spawn_ranks(fn, n, args)` starts n processes (torch.multiprocessing,
start method spawn), joins them into one process group through a
rendezvous file in a new temporary directory (no TCP port, so that several
such runs can share a host), calls fn(rank, n, *args) in each and returns
the results in rank order. It is how the multi-rank CPU tests,
parallel/dryrun.dryrun_multichip and the card's smoke script start their
ranks; torchrun starts the recipe's.

No failure is swallowed and nothing waits forever: a rank that raises sends
its traceback and the call raises at once; a rank that dies without a word,
or a run past `timeout_s`, raises too; the remaining ranks are killed
either way. The collectives of the group, and of the groups that
mesh.make_mesh creates in it, fail after `collective_timeout_s`.
`fn` must be importable by name (a module-level function), its arguments
and result picklable; results travel by value (torch tensors included).
"""

from __future__ import annotations

import pickle
import queue
import tempfile
import time
import traceback
from pathlib import Path


def _rank_main(fn, rank, world_size, backend, init_method, collective_timeout_s, args, out):
    import torch.distributed as dist

    from .mesh import init_distributed

    try:
        init_distributed(backend, init_method, rank, world_size, timeout_s=collective_timeout_s)
        out.put((rank, True, pickle.dumps(fn(rank, world_size, *args))))
        dist.barrier()  # no rank leaves the group while another still joins or uses it
        dist.destroy_process_group()
    except Exception:
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn, world_size: int, args: tuple = (), backend: str = "gloo",
                timeout_s: float = 120.0, collective_timeout_s: float = 60.0) -> list:
    """fn(rank, world_size, *args) on `world_size` new processes joined in a
    `backend` group; the results in rank order. Raises RuntimeError when a
    rank fails or dies, TimeoutError past `timeout_s`."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, init, collective_timeout_s,
                                   args, out))
                 for r in range(world_size)]
        deadline = time.monotonic() + timeout_s
        results, errors = {}, {}
        try:
            for p in procs:
                p.start()
            while len(results) < world_size and not errors:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world_size} ranks: no result from ranks "
                                       f"{sorted(set(range(world_size)) - set(results))} "
                                       f"within {timeout_s:.0f} s")
                try:
                    rank, ok, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:  # one last look for its traceback
                        try:
                            rank, ok, value = out.get(timeout=2.0)
                        except queue.Empty:
                            raise RuntimeError(
                                f"rank(s) {dead} exited with code(s) "
                                f"{[procs[r].exitcode for r in dead]} without a result")
                    else:
                        continue
                (results if ok else errors)[rank] = value
            if errors:
                rank = min(errors)
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{errors[rank]}")
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            out.close()
        return [pickle.loads(results[r]) for r in range(world_size)]

"""Ranks as threads of one process: torch's threaded process group
(``torch.testing._internal.distributed.multi_threaded_pg``), for several
ranks of a sharded program on one card. NCCL refuses two ranks on one
card, and gloo's all-gather of CUDA tensors under DTensor crashed on the
H100 (a SIGSEGV, where its all-reduce and reduce-scatter worked).

    with ThreadedRanks():
        results = rank_threads(fn, 4)      # fn(rank) in 4 threads
"""

from __future__ import annotations

import threading
import traceback

import torch
import torch.distributed as dist


def rank_threads(fn, world):
    """``fn(rank)`` in ``world`` threads, each a rank of torch's threaded
    process group (installed by :class:`ThreadedRanks`). Each thread runs
    its backward itself (autograd's device thread would serialise the
    ranks' backward passes, whose collectives wait on each other). Returns
    the results by rank; raises the first rank's error, or if a rank
    hangs."""
    store = dist.HashStore()
    results, errors = {}, {}

    def body(rank):
        try:
            with torch.autograd.set_multithreading_enabled(False):
                # the group lives in this thread's world, which the caller
                # drops (torch 2.11 cannot destroy a threaded group)
                dist.init_process_group("threaded", rank=rank,
                                        world_size=world, store=store)
                results[rank] = fn(rank)
        except BaseException as e:       # handed to the caller, who raises
            errors[rank] = e
            traceback.print_exc()

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a rank thread did not finish")
    if errors:
        raise errors[min(errors)]
    return [results[r] for r in range(world)]


class ThreadedRanks:
    """The threaded process group installed for a block, and removed."""

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from torch.testing._internal.distributed import multi_threaded_pg

        torch._C._distributed_c10d._set_thread_isolation_mode(True)
        multi_threaded_pg._install_threaded_pg()
        self.lock = getattr(ShardingPropagator, "_fake_mode_lock", None)
        if self.lock is not None:
            ShardingPropagator._fake_mode_lock = threading.Lock()
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from torch.testing._internal.distributed import multi_threaded_pg

        multi_threaded_pg._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        if self.lock is not None:
            ShardingPropagator._fake_mode_lock = self.lock

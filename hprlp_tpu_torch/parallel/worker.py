"""One rank of a mesh started by parallel/distributed.py::launch.

    python -m hprlp_tpu_torch.parallel.worker TASK OUT RANK WORLD PORT \\
        DEVICE_TYPE T0 THREADS

Joins the group (PORT: the rendezvous store's on 127.0.0.1, which the
launching process serves; DEVICE_TYPE: "cuda" for NCCL on cuda:RANK,
"cpu" for gloo), runs the call
pickled in TASK ((fn, args, kwargs)), and pickles (its return value, the
seconds from T0, the launch's time.time(), to the group being up) to OUT.
A rank must not import JAX: it fails if anything did.  Any failure exits
non-zero with the traceback on stderr.
"""

from __future__ import annotations

import os
import pickle
import sys
import time


def _no_jax(when: str) -> None:
    if "jax" in sys.modules:
        raise RuntimeError(f"a mesh rank imported JAX ({when})")


def main(argv) -> int:
    task, out, rank, world, port, device_type, t0, threads = argv
    import torch
    import torch.distributed as dist

    from . import distributed

    torch.set_num_threads(int(threads))
    distributed.initialize(world_size=int(world), rank=int(rank),
                           device_type=device_type,
                           store=distributed.client_store(port, world))
    start_s = time.time() - float(t0)
    dev = ("cpu" if device_type == "cpu"
           else f"cuda:{torch.cuda.current_device()} "
                f"({torch.cuda.get_device_name()})")
    print(f"[mesh rank {rank}/{world}] {dev}, group up in {start_s:.3f} s",
          file=sys.stderr, flush=True)
    _no_jax("at start")
    with open(task, "rb") as f:
        fn, args, kwargs = pickle.load(f)
    value = fn(*args, **kwargs)
    _no_jax("after its call")
    with open(out + ".tmp", "wb") as f:
        pickle.dump((value, start_s), f)
    os.replace(out + ".tmp", out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

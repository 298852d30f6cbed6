"""Process groups for mesh solves: one process (rank) per card, SPMD.

Counterpart of hprlp_tpu/parallel/distributed.py.  The JAX package runs a
mesh inside one process (or one per host, wired by
jax.distributed.initialize); PyTorch's idiom is one process per card in a
torch.distributed group: NCCL between cards, gloo on the CPU.  Every rank
runs the ordinary solve on its own device with the same problem: the
matrix is column-sharded (parallel/sharded.py) and the vectors are
replicated, so every rank returns the same Results.

Two ways in:

* Inside a group.  Start the ranks with torchrun (or any launcher) and
  call `initialize()` on each, then solve with
  Parameters(mesh_shape=world_size()):

      import hprlp_tpu_torch.parallel.distributed as dist
      dist.initialize()                 # torchrun's environment
      res = solve_problem(problem, Parameters(mesh_shape=dist.world_size()))

* Without a group, solve_problem / solve_batched / Model.solve with
  mesh_shape=N start N ranks themselves through `launch` (fresh
  interpreters running parallel/worker.py) and return rank 0's result:
  the JAX package's single-process mesh call.

The JAX module's `global_put` and `host_fetch` have no counterpart: they
place and fetch arrays sharded across the devices of one process, and
here each rank holds whole (replicated) vectors on its own card.

A collective that waits longer than PG_TIMEOUT_S fails its rank, and
`launch` raises as soon as a rank fails, so a failed or diverged rank ends
the solve with an error rather than hanging it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

# A collective (or the rendezvous) that waits longer than this fails.
PG_TIMEOUT_S = 600
# A launched mesh may run this long beyond the solve's time limit (the
# ingest, the power method and the capture are outside that clock).
LAUNCH_SLACK_S = 1800
# The end of a failed rank's stderr that launch's error carries.
STDERR_TAIL = 4000
WORKER = "hprlp_tpu_torch.parallel.worker"


def backend_for(device_type: str) -> str:
    """The collective backend of a device type: NCCL between cards, gloo
    on the CPU."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device type "
                     f"{device_type!r}")


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               device_type: str = "cuda") -> None:
    """Join this process to the default group (idempotent: nothing
    happens if it is initialized already).  With no arguments the
    rendezvous, world size and rank come from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); else pass them, e.g.
    init_method="tcp://host:port".  device_type "cuda" takes NCCL and
    sets this process's card to cuda:{local_rank()}; "cpu" takes gloo."""
    if dist.is_initialized():
        return
    backend = backend_for(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


def in_group() -> bool:
    """Whether this process has joined a default group."""
    return dist.is_initialized()


def world_size() -> int:
    """Ranks in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's rank on its host (torchrun's LOCAL_RANK, which
    `launch` sets too), which picks its card; the rank without it."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def is_multihost() -> bool:
    """Whether the group has more than one process (each rank is one)."""
    return world_size() > 1


def global_device_count() -> int:
    """The cards a mesh may span: the group's ranks inside a group, else
    the cards of this host (a launch maps one rank to each)."""
    if dist.is_initialized():
        return world_size()
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def mesh_device(device) -> torch.device:
    """The device of this rank of a mesh: the CPU when `device` asks for
    it, else cuda:{local_rank()}.  Raises without CUDA, when the local
    rank has no card, or when `device` names another card."""
    want = torch.device("cuda" if device is None else device)
    if want.type == "cpu":
        return want
    if want.type != "cuda":
        raise ValueError(f"a mesh runs on CUDA devices or the CPU, not "
                         f"{want}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to solve on the CPU")
    lr = local_rank()
    if lr >= torch.cuda.device_count():
        raise ValueError(f"local rank {lr} has no card: this host has "
                         f"{torch.cuda.device_count()} (one rank per card)")
    if want.index is not None and want.index != lr:
        raise ValueError(f"under a mesh rank {lr} runs on cuda:{lr}, not "
                         f"{want}")
    return torch.device(f"cuda:{lr}")


def check_group(mesh_shape: int, device: torch.device) -> None:
    """Raise unless this process's group can run a mesh of `mesh_shape`
    ranks on `device`: the world size must equal it, and the group's
    backend must be the device's (NCCL on a card, gloo on the CPU)."""
    if mesh_shape != world_size():
        raise ValueError(f"mesh_shape={mesh_shape} in a process group of "
                         f"{world_size()} ranks: they must be equal")
    want = backend_for(device.type)
    if want not in str(dist.get_backend()):
        raise ValueError(f"the process group's backend is "
                         f"{dist.get_backend()}; a mesh on {device.type} "
                         f"needs {want}")


def check_launch(mesh_shape: int, device) -> str:
    """The device type of a launch of `mesh_shape` ranks for `device`
    (None: the cards), raising when it cannot run: a rank per card, so no
    more ranks than this host's cards, ranks on cards 0..N-1."""
    if not isinstance(mesh_shape, int) or mesh_shape < 1:
        raise ValueError(f"mesh_shape must be a positive int, got "
                         f"{mesh_shape!r}")
    want = torch.device("cuda" if device is None else device)
    if want.type == "cpu":
        return "cpu"
    if want.type != "cuda":
        raise ValueError(f"a mesh runs on CUDA devices or the CPU, not "
                         f"{want}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to solve on the CPU")
    n = torch.cuda.device_count()
    if mesh_shape > n:
        raise ValueError(f"mesh_shape={mesh_shape} on a host with {n} "
                         f"card(s): NCCL runs one rank per card")
    if want.index not in (None, 0):
        raise ValueError(f"a launched mesh runs rank r on cuda:r; got "
                         f"{want}")
    return "cuda"


def all_ranks_max(values, device: torch.device) -> list[float]:
    """The element-wise maximum of `values` (floats) over the ranks."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def broadcast_object(obj, device: torch.device, src: int = 0):
    """Rank `src`'s `obj` on every rank of the default group: pickled on
    `src`, its bytes broadcast as one uint8 tensor on `device` (through
    the card under NCCL, as broadcast_object_list stages them), unpickled
    on the others; `src` keeps its own object.  The pickled bytes are
    held once on the host of `src` (the tensor reads them in place) and
    dropped once on `device`; a receiver drops the device tensor before it
    unpickles its host copy.  After the call broadcast_object.record holds
    {"bytes", "seconds"}."""
    t0 = time.perf_counter()
    mine = rank() == src
    size = torch.zeros(1, dtype=torch.int64, device=device)
    if mine:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        size[0] = len(data)
        with warnings.catch_warnings():
            # Read-only: the tensor is only read (copied, or sent).
            warnings.simplefilter("ignore", UserWarning)
            buf = torch.from_numpy(np.frombuffer(data, dtype=np.uint8))
        buf = buf.to(device)
        del data
    dist.broadcast(size, src)
    nbytes = int(size.item())
    if not mine:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dist.broadcast(buf, src)
    if not mine:
        host = buf.cpu()
        del buf
        obj = pickle.loads(memoryview(host.numpy()))
        del host
    else:
        del buf
    broadcast_object.record = {"bytes": nbytes,
                               "seconds": time.perf_counter() - t0}
    return obj


broadcast_object.record = None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _import_root(fn) -> str | None:
    """The sys.path entry from which fn's module imports, when that is not
    where this package imports from."""
    mod = sys.modules.get(getattr(fn, "__module__", ""), None)
    path = getattr(mod, "__file__", None)
    if path is None:
        return None
    root = os.path.dirname(os.path.abspath(path))
    for _ in range(fn.__module__.count(".")
                   + (os.path.basename(path) == "__init__.py")):
        root = os.path.dirname(root)
    return root


def _tail(path: str) -> str:
    with open(path, "rb") as f:
        data = f.read()
    return data[-STDERR_TAIL:].decode(errors="replace")


def launch(fn, args=(), kwargs=None, world: int = 1,
           device_type: str = "cuda", timeout: float | None = None) -> list:
    """Run fn(*args, **kwargs) on `world` ranks, each a fresh interpreter
    (python -m hprlp_tpu_torch.parallel.worker) in a group of `world`
    ranks that rendezvous on a TCP store at a free port of 127.0.0.1:
    NCCL with rank r on cuda:r for device_type "cuda", gloo for "cpu".
    fn must be importable by name (a module-level function); each rank
    gets its rank, world size and rendezvous on its command line and the
    call, pickled, in a file.  Returns every rank's return value, by rank.

    The ranks' standard output is this process's; each rank's standard
    error is relayed after it ends.  If a rank fails, or the launch
    outlives `timeout` seconds, the other ranks are killed and
    RuntimeError is raised with the failed rank's stderr tail.  After the
    call, launch.record holds {"world", "start_s": each rank's seconds from
    its start to its group being up, "wall_s"}."""
    backend_for(device_type)
    launch.record = None
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = [here]
    root = _import_root(fn)
    if root is not None and root != here:
        paths.append(root)
    if os.environ.get("PYTHONPATH"):
        paths.append(os.environ["PYTHONPATH"])
    threads = (max(1, torch.get_num_threads() // world)
               if device_type == "cpu" else torch.get_num_threads())
    with tempfile.TemporaryDirectory(prefix="hprlp_mesh_") as tmp:
        task = os.path.join(tmp, "task.pkl")
        with open(task, "wb") as f:
            pickle.dump((fn, tuple(args), dict(kwargs or {})), f)
        init = f"tcp://127.0.0.1:{_free_port()}"
        t0 = time.time()
        procs, errs, outs = [], [], []
        try:
            for r in range(world):
                env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths),
                           LOCAL_RANK=str(r))
                if device_type == "cpu":
                    # gloo's pairs on the loopback device, where the ranks
                    # meet (its default, the hostname's, may be slower).
                    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
                errs.append(os.path.join(tmp, f"rank{r}.err"))
                outs.append(os.path.join(tmp, f"rank{r}.pkl"))
                with open(errs[-1], "wb") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", WORKER, task, outs[-1],
                         str(r), str(world), init, device_type, repr(t0),
                         str(threads)], stderr=err, env=env))
            failed = _wait(procs, None if timeout is None else t0 + timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if failed:
            raise RuntimeError("\n".join(
                f"mesh rank {r} of {world} {why}; its stderr ends:\n"
                f"{_tail(errs[r])}" for r, why in failed))
        for path in errs:
            with open(path, errors="replace") as f:
                sys.stderr.write(f.read())
        results, starts = [], []
        for path in outs:
            with open(path, "rb") as f:
                value, start_s = pickle.load(f)
            results.append(value)
            starts.append(start_s)
    launch.record = {"world": world, "start_s": starts,
                     "wall_s": time.time() - t0}
    return results


launch.record = None


def _wait(procs, deadline) -> list:
    """Poll the ranks until all exit 0 ([]) or some fail: [(rank, what
    happened)] of the ranks that had failed when the first failure was
    seen, or of those still running at the deadline."""
    while True:
        codes = [p.poll() for p in procs]
        failed = [(r, f"exited with code {rc}") for r, rc in enumerate(codes)
                  if rc not in (None, 0)]
        if failed:
            return failed
        if all(rc == 0 for rc in codes):
            return []
        if deadline is not None and time.time() > deadline:
            return [(r, "outlived the launch's timeout")
                    for r, rc in enumerate(codes) if rc is None]
        time.sleep(0.02)

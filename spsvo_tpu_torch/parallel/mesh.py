"""The device mesh: one process per GPU on `torch.distributed`, the
counterpart of the JAX package's `make_mesh` (a 1-D `Mesh(("data",))`).

A `Mesh` is a process group and this process's place in it: `rank`, `size`,
the `device` it computes on and the `backend` that carries its collectives.
The sharded paths (`parallel.sharding` with `mesh=`,
`training.build_sharded_train_step`) need only the few collectives here:

  * `gather_frames`: every rank's rows of a few tensors, concatenated in
    rank order on every rank (an all-gather; ranks may hold different row
    counts, each pads to the largest and the receiver trims);
  * `halo_next`: a rank's first frame sent to the rank before it;
  * `all_reduce_mean`: a weighted mean over ranks;
  * `broadcast`: rank 0's tensors on every rank.

Each packs its tensors into one byte buffer, so a collective is one call
whatever the tensors' dtypes (bool and bf16 included) and the values
arrive bit for bit. NCCL moves CUDA buffers itself. Gloo's support for
CUDA tensors in all-gather and point-to-point is partial, so under gloo
every buffer goes through host memory explicitly (`Mesh.staged`): a
choice made here from the backend, never from a failed call.

`make_mesh` reads `RANK` / `WORLD_SIZE` / `LOCAL_RANK` as `torchrun` sets
them or takes an explicit `init_method`. A process alone gets a mesh of one
without a process group (`Mesh.alone`): at size 1 no collective reaches
`torch.distributed`, and nothing is left initialised behind the caller.
Its default is NCCL on `cuda:LOCAL_RANK`; gloo on the CPU only when the
caller asks for `device="cpu"`. `spawn` runs a function on several
ranks from one process (the counterpart of the JAX package's virtual CPU
mesh), each rank a fresh process, with a hard timeout.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT_S = 300.0        # a collective's wait for its peers


@dataclasses.dataclass
class Mesh:
    group: Optional["dist.ProcessGroup"]    # None for a mesh of one
    rank: int
    size: int
    device: torch.device
    backend: str

    @classmethod
    def alone(cls, device, backend: Optional[str] = None) -> "Mesh":
        """A mesh of one on `device`, without a process group: every
        collective is the identity (the unsharded program)."""
        device = torch.device(device)
        return cls(None, 0, 1, device, backend or _default_backend(device))

    @property
    def staged(self) -> bool:
        """Whether buffers travel through host memory (gloo)."""
        return self.backend == "gloo"

    # -- transport ---------------------------------------------------------
    def _out(self, buf: torch.Tensor) -> torch.Tensor:
        return buf.cpu() if self.staged else buf

    def _back(self, buf: torch.Tensor) -> torch.Tensor:
        return buf.to(self.device) if self.staged else buf

    def barrier(self) -> None:
        if self.size > 1:
            t = self._out(torch.zeros(1, device=self.device))
            dist.all_reduce(t, group=self.group)

    # -- the collectives ---------------------------------------------------
    def gather_frames(self, tensors: Sequence[torch.Tensor],
                      counts: Sequence[int]) -> List[torch.Tensor]:
        """`tensors` hold this rank's `counts[rank]` rows (leading
        dimension); returns each tensor with every rank's rows concatenated
        in rank order, on every rank."""
        if self.size == 1:
            return list(tensors)
        if len(counts) != self.size:
            raise ValueError(f"{len(counts)} counts for {self.size} ranks")
        mine = counts[self.rank]
        for t in tensors:
            if t.shape[0] != mine:
                raise ValueError(f"rank {self.rank} holds {t.shape[0]} rows, "
                                 f"counts say {mine}")
        specs = [(tuple(t.shape[1:]), t.dtype) for t in tensors]
        sizes = [_packed_size([(c,) + s for s, _ in specs],
                              [d for _, d in specs]) for c in counts]
        buf = _pack(tensors, self.device)
        width = max(sizes)
        buf = torch.cat([buf, buf.new_zeros(width - buf.numel())])
        out = self._out(buf)
        if self.staged:
            parts = [torch.empty_like(out) for _ in range(self.size)]
            dist.all_gather(parts, out, group=self.group)
        else:
            whole = out.new_empty(self.size * width)
            dist.all_gather_into_tensor(whole, out, group=self.group)
            parts = list(whole.split(width))
        per_rank = [_unpack(self._back(p), [(c,) + s for s, _ in specs],
                            [d for _, d in specs])
                    for p, c in zip(parts, counts)]
        return [torch.cat([r[i] for r in per_rank])
                for i in range(len(tensors))]

    def halo_next(self, tensors: Sequence[torch.Tensor]
                  ) -> Optional[List[torch.Tensor]]:
        """Every rank sends `tensors` (its first frame's) to the rank before
        it and receives the next rank's, of the same shapes and dtypes;
        None on the last rank."""
        shapes = [tuple(t.shape) for t in tensors]
        dtypes = [t.dtype for t in tensors]
        works = []
        if self.rank > 0:
            send = self._out(_pack(tensors, self.device))
            works.append(dist.isend(send, self.rank - 1, group=self.group))
        recv = None
        if self.rank < self.size - 1:
            recv = self._out(torch.empty(_packed_size(shapes, dtypes),
                                         dtype=torch.uint8,
                                         device=self.device))
            works.append(dist.irecv(recv, self.rank + 1, group=self.group))
        for w in works:
            w.wait()
        if recv is None:
            return None
        return _unpack(self._back(recv), shapes, dtypes)

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor],
                        weight: float = 1.0) -> List[torch.Tensor]:
        """sum_r weight_r * x_r / sum_r weight_r for each tensor, in
        float32 (one all-reduce), returned in each tensor's dtype."""
        if self.size == 1:
            return list(tensors)
        flat = torch.cat([t.reshape(-1).float() * weight for t in tensors]
                         + [torch.full((1,), float(weight),
                                       device=self.device)])
        out = self._out(flat)
        dist.all_reduce(out, group=self.group)
        flat = self._back(out)
        flat = flat[:-1] / flat[-1]
        res, off = [], 0
        for t in tensors:
            res.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
            off += t.numel()
        return res

    def broadcast(self, tensors: Sequence[torch.Tensor], src: int = 0
                  ) -> List[torch.Tensor]:
        """Rank `src`'s `tensors` on every rank (the others pass tensors of
        the same shapes and dtypes), bit for bit."""
        if self.size == 1:
            return list(tensors)
        shapes = [tuple(t.shape) for t in tensors]
        dtypes = [t.dtype for t in tensors]
        buf = self._out(_pack(tensors, self.device))
        dist.broadcast(buf, src, group=self.group)
        return _unpack(self._back(buf), shapes, dtypes)


# -- byte packing ----------------------------------------------------------

_ALIGN = 16


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= s
    return n * torch.empty((), dtype=dtype).element_size()


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _packed_size(shapes, dtypes) -> int:
    return sum(_padded(_nbytes(s, d)) for s, d in zip(shapes, dtypes))


def _pack(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The tensors' bytes, each segment padded to 16 bytes, as one uint8
    vector on `device`."""
    parts = []
    for t in tensors:
        # a fresh 1-D copy: a size-1 view may keep a stride other than 1
        flat = torch.empty(t.numel(), dtype=t.dtype, device=device)
        b = flat.copy_(t.detach().reshape(-1)).view(torch.uint8)
        parts.append(b)
        pad = _padded(b.numel()) - b.numel()
        if pad:
            parts.append(b.new_zeros(pad))
    if not parts:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, shapes, dtypes) -> List[torch.Tensor]:
    out, off = [], 0
    for s, d in zip(shapes, dtypes):
        n = _nbytes(s, d)
        out.append(buf[off:off + n].clone().view(d).reshape(s))
        off += _padded(n)
    return out


# -- shard layout ----------------------------------------------------------

def shard_bounds(n: int, size: int) -> List[Tuple[int, int]]:
    """The frames [a_r, b_r) rank r holds of n, in order: a_r = r n // size
    (equal shards when size divides n)."""
    return [(r * n // size, (r + 1) * n // size) for r in range(size)]


def pair_counts(n: int, size: int) -> List[int]:
    """The frame pairs (p, p + 1) each rank builds: those whose first frame
    it holds; the last rank has one fewer."""
    return [min(b, n - 1) - a for a, b in shard_bounds(n, size)]


# -- making a mesh ---------------------------------------------------------

def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(n_devices: Optional[int] = None, *, device="cuda",
              backend: Optional[str] = None,
              init_method: Optional[str] = None) -> Mesh:
    """This process's place in the mesh of every process of the job.

    The group is the one already initialised, or one made here from
    `init_method` (`file://...`, `tcp://host:port`) or the environment
    (`torchrun`), with `RANK` and `WORLD_SIZE` from the environment. A job
    of one rank (`WORLD_SIZE` absent or 1) with no initialised group gets
    `Mesh.alone`: no process group is made. `device` "cuda" means
    `cuda:LOCAL_RANK`; an explicit index is kept (several ranks may share a
    card under gloo). `backend` defaults to NCCL on CUDA and gloo on the
    CPU; NCCL on the CPU is refused. A collective that waits on a missing
    peer fails after TIMEOUT_S. `n_devices`, if given, must equal the
    world size."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' for "
                           "a gloo mesh on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: unsupported device {device}")
    backend = backend or _default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: unsupported backend {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("make_mesh: NCCL needs a CUDA device")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _env_int("LOCAL_RANK", 0))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialised = dist.is_available() and dist.is_initialized()
    if initialised and dist.get_backend() != backend:
        raise ValueError(f"make_mesh: a {dist.get_backend()} group is "
                         f"already initialised, {backend} was asked for")
    world = (dist.get_world_size() if initialised
             else _env_int("WORLD_SIZE", 1))
    if n_devices not in (None, world):
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the job "
                         f"has {world} ranks")
    if not initialised:
        if world == 1:
            return Mesh.alone(device, backend)
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=_env_int("RANK", 0), world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Mesh(dist.group.WORLD, dist.get_rank(), world, device, backend)


def build_kernels(mesh: Mesh, names: Sequence[str]) -> None:
    """Build the CUDA kernels `names` on rank 0 while the others wait, then
    load them everywhere from the cache (one `nvcc` per kernel per job).
    Alone, a kernel is built at its first launch."""
    if mesh.device.type != "cuda" or not names or mesh.size == 1:
        return
    from spsvo_tpu_torch import _build
    if mesh.rank == 0:
        _build.load_all(names)
    mesh.barrier()
    _build.load_all(names)


# -- several ranks from one process ----------------------------------------

def _rank_main(fn, rank, world, device, backend, init_method, args, threads,
               results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = make_mesh(device=device, backend=backend,
                         init_method=init_method)
        out = fn(mesh, *args)
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:     # a failed check exits: report it, then exit
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, device="cpu",
          backend: Optional[str] = None, args: tuple = (),
          timeout_s: float = 600.0, threads: Optional[int] = None) -> list:
    """`fn(mesh, *args)` on `world` ranks, each a fresh process (spawned;
    `fn` and `args` must pickle, `fn` at a module's top level); returns the
    ranks' results in rank order. The ranks meet through a file store in a
    temporary directory. A rank that raises fails the call with its
    traceback; past `timeout_s` every rank still running is killed and the
    call fails. `threads` sets each rank's torch threads."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="spsvo_mesh_")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, device, backend, init_method,
                               args, threads, results))
             for r in range(world)]
    out, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world)) - set(out))
                raise TimeoutError(f"spawn: ranks {late} did not finish "
                                   f"within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(1.0)        # a last result may be in flight
                    if results.empty():
                        raise RuntimeError(f"spawn: a rank exited with "
                                           f"{dead} without a result")
                continue
            if ok:
                out[rank] = pickle.loads(payload)
            else:
                errors.append((rank, payload))
                break                      # the others may wait on it
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"spawn: rank {rank} failed:\n{tb}")
        return [out[r] for r in range(world)]
    finally:
        done = len(out) == world   # else the others may wait for ever
        for p in procs:
            if not done and p.is_alive():
                p.kill()
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)

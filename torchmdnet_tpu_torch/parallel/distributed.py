"""Multi-process execution over ``torch.distributed`` (counterpart of
torchmdnet_tpu/parallel/distributed.py).

The reference trains on several GPUs and hosts with Lightning DDP and an
environment rendezvous (``MASTER_ADDR``, ``MASTER_PORT``, ``NODE_RANK`` and
``--num-nodes``).  The port does it PyTorch's way:

1. one process per rank (``launch`` starts ``--ndevices`` of them on a node);
   :func:`initialize_distributed` joins them into one process group from the
   reference's variables;
2. each rank's loader collates only its slice of every global batch
   (``PaddedLoader(process_rank=..., process_count=...)``), with global
   molecule ids; :func:`localize_shard` renumbers them for the rank's own
   forward;
3. parameters start identical (the seeded init, then :func:`broadcast_`
   from rank 0), and each step's gradients are summed over the ranks by one
   ``all_reduce`` (:func:`sum_gradients`), so every rank takes the same step.

Backend: NCCL where every rank of a node owns its own GPU; gloo on the CPU
and where ranks share one card (NCCL refuses two ranks on one device), or
as ``initialize_distributed(backend=...)`` names it.  Under gloo, tensors
on the card are staged through host copies for every collective, so one
code path serves both backends.  The gradient sum is the backend's
all-reduce, which gives every rank the same bits and repeats from run to run
on a fixed layout; the small sums of edge partitioning and of the metrics
are gathered and added in rank order (:func:`sum_in_rank_order`), whatever
the backend.
"""

import math
import os
import socket
import subprocess
import sys
from typing import List, Optional, Sequence

import torch

def choose_backend(device, ranks_per_node: int) -> str:
    """gloo on the CPU and where ranks share a card, NCCL otherwise."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available() or ranks_per_node > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def initialize_distributed(num_nodes: int = 1, *, coordinator: Optional[str] = None,
                           port: Optional[str] = None, rank: Optional[int] = None,
                           ranks_per_node: Optional[int] = None, local_rank: Optional[int] = None,
                           device=None, backend: Optional[str] = None):
    """Join this process to the run's process group from the reference's
    variables; returns (process_index, process_count).

    A no-op (0, 1) on one node with one rank and no ``MASTER_ADDR``, so a
    single-process run is unchanged.  Variables (reference README.md:70-81):
    ``MASTER_ADDR``/``MASTER_PORT`` the coordinator (required on every node
    when num_nodes > 1), ``NODE_RANK`` this node's rank; ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` this process's rank on its node and the ranks a node
    (``launch`` sets them).  Keyword arguments override the variables.  The
    global rank is NODE_RANK * ranks_per_node + LOCAL_RANK.  ``backend``
    (default :func:`choose_backend`'s) names the backend: gloo for nodes
    that share one card, which no variable tells a rank.
    """
    import torch.distributed as dist

    addr = coordinator or os.environ.get("MASTER_ADDR")
    per_node = int(ranks_per_node or os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if num_nodes <= 1 and per_node <= 1 and addr is None:
        return 0, 1
    if addr is None:
        raise ValueError(
            "--num-nodes > 1 requires MASTER_ADDR (and usually MASTER_PORT/NODE_RANK) in the "
            "environment, like the reference's DDP launch."
        )
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    port = port or os.environ.get("MASTER_PORT", "12355")
    node = int(os.environ.get("NODE_RANK", "0") if rank is None else rank)
    local = int(os.environ.get("LOCAL_RANK", "0") if local_rank is None else local_rank)
    world = int(num_nodes) * per_node
    global_rank = node * per_node + local
    backend = backend or choose_backend(device, per_node)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", world_size=world, rank=global_rank)
    return global_rank, world


def process_info():
    """(process_index, process_count); (0, 1) when not distributed."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier():
    """Block until every rank reaches this point (checkpoint hand-off)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# --- collectives on the mesh: fixed order, staged through the host under gloo


def _staged(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type != "cpu"


def all_gather_stack(mesh, t: torch.Tensor) -> torch.Tensor:
    """(D, ...) every rank's ``t`` in rank order, on ``t``'s device."""
    if not mesh.distributed:
        return t[None]
    import torch.distributed as dist

    src = t.detach().contiguous()
    if _staged(mesh, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src)
    return torch.stack(parts).to(t.device)


def sum_in_rank_order(mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``t``, added rank by rank: the same bits on
    every rank and from run to run."""
    parts = all_gather_stack(mesh, t)
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def max_over_ranks(mesh, t: torch.Tensor) -> torch.Tensor:
    return all_gather_stack(mesh, t).amax(dim=0)


def broadcast_(mesh, tensors: Sequence[torch.Tensor], src: int = 0):
    """Overwrite ``tensors`` in place with rank ``src``'s values (the
    counterpart of the JAX package's ``replicate_to_mesh``: parameters start
    identical on every rank)."""
    if not mesh.distributed:
        return
    import torch.distributed as dist

    with torch.no_grad():
        for t in tensors:
            buf = t.detach().contiguous()
            buf = buf.cpu() if _staged(mesh, buf) else buf.clone()
            dist.broadcast(buf, src)
            t.copy_(buf.to(t.device))


def all_to_all_rows(mesh, sends: List[torch.Tensor], recv_rows: List[int]) -> torch.Tensor:
    """Exchange rows: ``sends[p]`` (rows, ...) goes to rank p; returns the rows
    received from every rank, concatenated in rank order, (sum(recv_rows),
    ...).  One ``all_to_all_single`` on the rows' bytes (any dtype)."""
    own = sends[mesh.rank]
    trail, dtype, dev = tuple(own.shape[1:]), own.dtype, own.device
    if not mesh.distributed:
        return own.new_empty((0,) + trail)
    import torch.distributed as dist

    cols = math.prod(trail)
    width = own.element_size() * cols
    flat = torch.cat([s.contiguous().reshape(s.shape[0], cols) for s in sends])
    raw = flat.view(torch.uint8).reshape(flat.shape[0], width)
    out = torch.empty((sum(recv_rows), width), dtype=torch.uint8, device=dev)
    if _staged(mesh, raw):
        raw, host_out = raw.cpu(), out.cpu()
        dist.all_to_all_single(host_out, raw, output_split_sizes=list(recv_rows),
                               input_split_sizes=[s.shape[0] for s in sends])
        out = host_out.to(dev)
    else:
        dist.all_to_all_single(out, raw, output_split_sizes=list(recv_rows),
                               input_split_sizes=[s.shape[0] for s in sends])
    return out.view(dtype).reshape((sum(recv_rows),) + trail)


# --- data parallelism


def localize_shard(batch, process_rank: int):
    """A rank's shard of a global batch (``pad_molecules`` with
    ``mol_id_offset``/``num_mol_global``: global molecule ids, the global
    trash segment, ``num_mol`` the global capacity) renumbered for its own
    forward: ids 0..m-1 of its m molecule slots, padding atoms in segment m,
    ``num_mol`` m.  Predictions then line up with the shard's labels."""
    m = batch.mol_mask.shape[0]
    if batch.num_mol == m:
        return batch
    ids = batch.batch - process_rank * m
    ids = torch.where(batch.atom_mask, ids, torch.full_like(ids, m))
    return batch.replace(batch=ids, num_mol=m)


def sum_gradients(mesh, params, extra: Optional[torch.Tensor] = None):
    """Replace each parameter's gradient by its sum over the ranks: one
    ``all_reduce`` of the flattened gradients, which moves and holds one copy
    of them whatever the rank count; ``extra`` (a 1-D tensor of loss terms)
    rides along and comes back summed."""
    grads = [p.grad.reshape(-1) for p in params]
    pieces = grads + ([extra.to(grads[0].dtype)] if extra is not None else [])
    total = torch.cat(pieces)
    if mesh.distributed:
        import torch.distributed as dist

        buf = total.cpu() if _staged(mesh, total) else total
        dist.all_reduce(buf)
        total = buf.to(total.device)
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(total[off:off + n].reshape(p.grad.shape))
        off += n
    return total[off:] if extra is not None else None


# --- starting the ranks of one node


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], nprocs: int, env: Optional[dict] = None, timeout: Optional[float] = None) -> int:
    """Start ``nprocs`` ranks of this node, each ``python argv...`` with
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` set (and ``MASTER_ADDR`` localhost
    and a free ``MASTER_PORT`` when the environment names no coordinator);
    wait for all of them and return the first nonzero exit code (0 if all
    succeed).  A rank that fails stops the others."""
    base = dict(os.environ if env is None else env)
    base.setdefault("MASTER_ADDR", "localhost")
    base.setdefault("MASTER_PORT", str(free_port()))
    base["LOCAL_WORLD_SIZE"] = str(nprocs)
    procs = []
    for r in range(nprocs):
        e = dict(base, LOCAL_RANK=str(r))
        procs.append(subprocess.Popen([sys.executable] + list(argv), env=e))
    rc = 0
    try:
        pending = list(procs)
        while pending:
            for p in list(pending):
                try:
                    code = p.wait(timeout=0.2)
                except subprocess.TimeoutExpired:
                    continue
                pending.remove(p)
                if code != 0 and rc == 0:
                    rc = code
                    for q in pending:
                        q.terminate()
            if timeout is not None:
                timeout -= 0.2
                if timeout <= 0:
                    raise subprocess.TimeoutExpired(argv, 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc

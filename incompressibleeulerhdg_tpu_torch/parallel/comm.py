"""The communicator of a distributed solve: one grid row to a neighbour,
the ghost entries of a partition, sums over all ranks, and the gather of a
result.

Counterpart of the collectives of incompressibleeulerhdg_tpu's ``shard_map``
step, ``lax.ppermute`` of one grid row (:meth:`Comm.halo`) and ``lax.psum``
(:meth:`Comm.allreduce`), and of the halo exchanges GSPMD inserts for the
facet<->cell gathers of its cell/facet sharding (:meth:`Comm.ghosts`).
Every distributed op of the port receives the :class:`Comm` through the
local geometry (``ops.structured.dist_axis``: ``geom.shift[6]`` on a slab,
``geom.part.comm`` on a partition).  Under NCCL the rows and ghosts are
``batch_isend_irecv`` and the sum an ``all_reduce`` on the card; gloo sends
host buffers, so a CUDA tensor's row, ghosts or sum pass through host
memory.  No op of a step gathers: :meth:`Comm.gather` brings a state to
rank 0 at a checkpoint, for an output, and at the end of a run.

``counts`` holds the halo exchanges, ghost exchanges, all-reduces and
gathers since the last :meth:`reset_counts`, the observables of the
decomposition's contract (one row per shift, one exchange per gather of a
changed source, sums for every inner product, no gather inside a step).
"""

import torch
import torch.distributed as dist

__all__ = ["Comm"]


class Comm:
    """One rank's view of the process group of a slab-decomposed run.

    :arg rank: this process's rank (= its slab)
    :arg size: the number of ranks (= slabs)
    :arg group: the process group (default: the world group)
    """

    def __init__(self, rank, size, group=None):
        self.rank = int(rank)
        self.size = int(size)
        self.group = group
        self.backend = dist.get_backend(group)
        self.counts = {"halo": 0, "ghosts": 0, "allreduce": 0, "gather": 0}

    def reset_counts(self):
        """Set every collective's count to zero."""
        for k in self.counts:
            self.counts[k] = 0

    def _host(self, t):
        """gloo moves host buffers: a CUDA tensor goes through host memory."""
        return self.backend == "gloo" and t.is_cuda

    def allreduce(self, t):
        """Sum of ``t`` over all ranks (a new tensor on ``t``'s device)."""
        self.counts["allreduce"] += 1
        if self._host(t):
            buf = t.detach().to("cpu", copy=True)
            dist.all_reduce(buf, group=self.group)
            return buf.to(t.device)
        buf = t.detach().clone()
        dist.all_reduce(buf, group=self.group)
        return buf

    def halo(self, row, dst, src):
        """Send ``row`` to rank ``dst`` and receive the same shape from rank
        ``src`` (either may be None); returns the received row, zeros when
        ``src`` is None (the zero fill of a Neumann end)."""
        self.counts["halo"] += 1
        send = row.contiguous()
        host = self._host(send)
        if host:
            send = send.cpu()
        recv = torch.empty_like(send) if src is not None else None
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, send, dst, self.group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv, src, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if recv is None:
            return torch.zeros_like(row)
        return recv.to(row.device) if host else recv

    def ghosts(self, plan, x):
        """``x`` (..., n_owned), this rank's entries, followed by its ghost
        entries from their owners: (..., n_owned + n_ghost), in the order of
        ``plan`` (a ``parallel.partition.GhostPlan``).  Every rank sends the
        entries the others hold as ghosts; a rank with nothing to move
        makes no call."""
        self.counts["ghosts"] += 1
        host = self._host(x)
        dev = torch.device("cpu") if host else x.device
        ops, recvs = [], []
        for peer, idx in plan.send:
            buf = x[..., idx].contiguous()
            ops.append(dist.P2POp(dist.isend, buf.cpu() if host else buf, peer, self.group))
        for peer, n in plan.recv:
            recvs.append(torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=dev))
            ops.append(dist.P2POp(dist.irecv, recvs[-1], peer, self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if not recvs:
            return x
        ghost = torch.cat(recvs, dim=-1)
        return torch.cat([x, ghost.to(x.device) if host else ghost], dim=-1)

    def gather(self, t):
        """Every rank's ``t`` (one shape on all ranks) at rank 0, as a list
        of host tensors in rank order; None on the other ranks."""
        self.counts["gather"] += 1
        t = t.detach().contiguous()
        host = self.backend == "gloo"
        if host:
            t = t.cpu()
        if self.rank != 0:
            dist.send(t, 0, group=self.group)
            return None
        out = [t.cpu()]
        for r in range(1, self.size):
            buf = torch.empty_like(t)
            dist.recv(buf, r, group=self.group)
            out.append(buf.cpu())
        return out

    def barrier(self):
        """Wait for every rank (an all-reduce of one element)."""
        dev = "cuda" if self.backend == "nccl" else "cpu"
        self.allreduce(torch.zeros(1, device=dev))

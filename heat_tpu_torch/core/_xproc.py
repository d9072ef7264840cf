"""The transport between the controller processes of a process-spanning
communicator (:func:`heat_tpu_torch.init_multihost`).

Such a communicator spans ``nprocs`` Python processes.  Process ``k``
owns the contiguous run of positions ``[k * pl, (k + 1) * pl)``, every
process the same number ``pl``, all of them on its one device.  Between
a process's own positions a collective stays a tensor op on the stacked
``(pl, ...)`` axis; between processes the tensors move through
``torch.distributed`` on the default process group.

The group's backend is gloo, on the CPU and on the card alike: NCCL
refuses two ranks on one device, and a one-card machine runs every
process on ``cuda:0``.  gloo moves host memory, so every cross-process
byte is staged through the host: a device tensor is copied to the host
before it is sent and back to its device after it arrives.  That is the
transport of a one-card machine (``TorchCommunication.backend`` and
``.transport`` name it), not a fallback.

Everything the port does not teach yet across processes refuses with
:func:`refuse`, whose ``NotImplementedError`` names the queue item that
brings it (ROADMAP A3b2); no result is ever computed on a partial slab.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: the queue item that brings what this slice refuses
NEXT_ITEM = "ROADMAP A3b2"

#: the only backend of this slice, and how its bytes travel
BACKEND = "gloo"
TRANSPORT = "gloo, staged through host memory"

#: what :func:`exchange` has sent to other processes in this process:
#: ``bytes`` and ``messages`` (a ring hop is one message)
SENT = {"bytes": 0, "messages": 0}


def refuse(what: str):
    """Raise the refusal of something not ported across processes."""
    raise NotImplementedError(
        f"{what} on a process-spanning communicator is not ported yet ({NEXT_ITEM})"
    )


def spans(*objs) -> bool:
    """True when any of ``objs`` (DNDarrays, communicators, None for the
    installed default communicator) spans processes."""
    for obj in objs:
        if obj is None:
            from . import communication

            obj = communication._default_comm
        if getattr(getattr(obj, "comm", obj), "spans_processes", False):
            return True
    return False


def refuse_across(what: str, *objs) -> None:
    """:func:`refuse` when any of ``objs`` spans processes."""
    if spans(*objs):
        refuse(what)


def _dist():
    import torch.distributed as dist

    return dist


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


def group_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def shutdown() -> None:
    """Destroy the default process group, if one is up."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world() -> Tuple[int, int]:
    """``(rank, nprocs)`` of the default process group."""
    dist = _dist()
    return dist.get_rank(), dist.get_world_size()


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (equal shapes and types everywhere), in
    process order, on ``t``'s device."""
    dist = _dist()
    host = _host(t)
    outs = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, host)
    return [o.to(t.device) for o in outs]


def all_gather_object(obj) -> list:
    """Every process's picklable ``obj``, in process order."""
    dist = _dist()
    outs = [None] * dist.get_world_size()
    dist.all_gather_object(outs, obj)
    return outs


def broadcast(t: Optional[torch.Tensor], src: int, shape, dtype, device) -> torch.Tensor:
    """Process ``src``'s ``t`` on every process (the others pass None and
    the shape and type it has)."""
    dist = _dist()
    buf = _host(t) if dist.get_rank() == src else torch.empty(tuple(shape), dtype=dtype)
    dist.broadcast(buf, src)
    return buf.to(device)


def exchange(sends: Dict[int, torch.Tensor], recvs: Dict[int, Tuple[Sequence[int], torch.dtype]],
             device) -> Dict[int, torch.Tensor]:
    """Point-to-point exchange: ``sends[j]`` goes to process ``j``, and
    ``recvs[j]`` gives the shape and type of what arrives from ``j``;
    both sides know every size, so nothing else is exchanged.  Empty
    messages are not sent.  A process's message to itself is returned
    as it is.  Returns the arrivals, on ``device``."""
    dist = _dist()
    rank = dist.get_rank()
    out: Dict[int, torch.Tensor] = {}
    ops, bufs = [], {}
    for j, (shape, dtype) in sorted(recvs.items()):
        if j == rank:
            continue
        buf = torch.empty(tuple(shape), dtype=dtype)
        if buf.numel():
            ops.append(dist.P2POp(dist.irecv, buf, j))
        bufs[j] = buf
    for j, t in sorted(sends.items()):
        if j == rank:
            out[j] = t
            continue
        if t.numel():
            ops.append(dist.P2POp(dist.isend, _host(t), j))
            SENT["bytes"] += t.numel() * t.element_size()
            SENT["messages"] += 1
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for j, buf in bufs.items():
        out[j] = buf.to(device)
    return out


def ring_shift(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One ring hop between processes: ``tensors`` go to the next process,
    in one message, and the previous process's (the same shapes and
    types) arrive and are returned."""
    rank, nprocs = world()
    nxt, prv = (rank + 1) % nprocs, (rank - 1) % nprocs
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    sizes = [int(f.numel()) for f in flat]
    got = exchange({nxt: torch.cat(flat)}, {prv: ((sum(sizes),), torch.uint8)},
                   tensors[0].device)[prv]
    out, at = [], 0
    for t, nb in zip(tensors, sizes):
        out.append(got[at:at + nb].clone().view(t.dtype).reshape(t.shape))
        at += nb
    return out

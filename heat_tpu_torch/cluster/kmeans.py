"""K-Means clustering (Lloyd's algorithm).

Port of ``heat_tpu/cluster/kmeans.py``: the exact Lloyd loop and the
``int8_block`` error-feedback loop, both on the reference's explicit
carry ``(it, centers, shift[, error])`` and its ``tol`` rule (a step runs
while ``it < max_iter`` and ``shift > tol``; ``tol < 0`` runs exactly
``max_iter`` steps).  Each step assigns by ``argmin_k(|c|^2 - 2 x.c)`` —
the row norms are constant across the k candidates — and updates with the
selection-matrix product ``one_hot(labels).T @ X``.

Under a compressing collective policy on a row-split input over several
positions, each step's ``(k, f)`` per-position centroid sums ride the
quantized ring with an error-feedback residual in the carry, while the
``(k,)`` counts combine exactly.  With telemetry on, the fit credits the
byte ledger with each segment's rings in one entry, as the reference's
does.

``checkpoint_every=N`` runs the Lloyd loop in N-step segments,
snapshotting the carry (the stacked error-feedback residual included)
between segments; ``fit(..., resume=True)`` continues bitwise where the
snapshot left off, ``resume="elastic"`` also onto another number of
positions.  ``mini_batch=`` (or a stream source as input) fits out of
core: incremental center updates over the chunks of
:func:`heat_tpu_torch.io.stream.stream_chunks`.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core._compile import jitted
from ..core._tracing import require_concrete
from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..telemetry import _core as _tel
from ._kcluster import _KCluster, _quadratic_cdist
from ..core._split_semantics import split_semantics as _split_semantics

__all__ = ["KMeans"]


def _assign(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest-center labels of the rows of ``a`` (batched over any
    leading position axis)."""
    c2 = torch.sum(c * c, dim=1)
    return torch.argmin(c2 - 2.0 * torch.matmul(a, c.T), dim=-1)


def _labels_inertia(arr: torch.Tensor, centers: torch.Tensor):
    """The final labels and the inertia of the fitted centers."""
    labels = _assign(arr, centers)
    return labels, torch.sum((arr - centers[labels]) ** 2)


def _one_hot(labels: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    return (labels.unsqueeze(-1) == torch.arange(k, device=labels.device)).to(dtype)


class KMeans(_KCluster):
    """K-Means estimator.

    Parameters
    ----------
    n_clusters : int
    init : ``'random'`` | ``'probability_based'`` (k-means++, also
        ``'kmeans++'``) | DNDarray of initial centroids
    max_iter : int
    tol : float — convergence threshold on the squared centroid shift
    random_state : int or None
    checkpoint_every : int — snapshot the Lloyd loop's carry every N
        steps (0, the default, never).  A fit killed at a segment boundary
        and restarted with ``fit(..., resume=True)`` replays the identical
        float trajectory; the ``int8_block`` loop snapshots its
        error-feedback residual too.
    checkpoint_path : str or None — the HDF5 snapshot (atomic writes;
        required when ``checkpoint_every > 0``).
    mini_batch : int or None — rows per chunk of the out-of-core fit.
        When set (or when ``fit`` receives a
        :class:`heat_tpu_torch.io.stream.StreamSource`), ``max_iter``
        counts epochs over a fixed chunk schedule, ``tol`` is not used,
        and the centers after each chunk move by the running-mean rule
        ``c += (batch_sum - batch_count c) / total_count``.
    """

    _init_plus_plus_alias = "kmeans++"

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
        checkpoint_every: int = 0,
        checkpoint_path: Optional[str] = None,
        mini_batch: Optional[int] = None,
    ):
        super().__init__(
            metric=_quadratic_cdist,
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
            checkpoint_every=checkpoint_every,
            checkpoint_path=checkpoint_path,
        )
        if mini_batch is not None and int(mini_batch) < 1:
            raise ValueError(f"mini_batch must be >= 1, got {mini_batch}")
        self.mini_batch = None if mini_batch is None else int(mini_batch)

    @staticmethod
    def _fit_segment(arr: torch.Tensor, tol: float, stop: int, carry):
        """Exact Lloyd steps on ``carry = (it, centers, shift)`` while
        ``it < stop`` and ``shift > tol``."""
        it, c, shift = carry
        k = c.shape[0]
        while it < stop and shift > tol:
            labels = _assign(arr, c)
            sel = _one_hot(labels, k, arr.dtype)
            sums = torch.matmul(sel.T, arr)
            counts = torch.sum(sel, dim=0)[:, None]
            nc = torch.where(counts > 0, sums / torch.clamp_min(counts, 1), c)
            shift = float(torch.sum((nc - c) ** 2))
            it, c = it + 1, nc
        return it, c, shift

    @staticmethod
    def _fit_segment_q(blocks: torch.Tensor, tol: float, stop: int, carry, *, mode: str):
        """The error-feedback loop on ``carry = (it, centers, shift,
        error)``: ``blocks`` is the ``(p, n/p, f)`` row blocks of the
        positions, ``error`` the stacked ``(p, k*f)`` residual."""
        from ..comm.compressed import ring_allreduce_q_ef

        it, c, shift, e = carry
        p = blocks.shape[0]
        k, f = c.shape
        while it < stop and shift > tol:
            labels = _assign(blocks, c)
            sel = _one_hot(labels, k, blocks.dtype)
            sums = torch.matmul(sel.transpose(1, 2), blocks)
            gcounts = torch.sum(sel, dim=(0, 1))[:, None]
            red, e = ring_allreduce_q_ef(sums.reshape(p, k * f), e, size=p, mode=mode)
            nc = torch.where(gcounts > 0.5, red.reshape(k, f) / torch.clamp_min(gcounts, 1.0), c)
            shift = float(torch.sum((nc - c) ** 2))
            it, c = it + 1, nc
        return it, c, shift, e

    @_split_semantics("entry_fit")
    def fit(self, x, resume=False, comm=None, device=None) -> "KMeans":
        """Lloyd iterations until the squared centroid shift is <= tol, or
        ``max_iter`` steps.

        With ``checkpoint_every=N`` the loop runs in N-step segments,
        snapshotting the carry between them; ``resume=True`` restarts from
        the snapshot (no center initialization) and finishes bitwise
        equal to an uninterrupted fit; ``resume="elastic"`` also takes a
        snapshot of another number of positions, migrating the stacked
        residual.  With ``mini_batch=`` set, or ``x`` a stream source, the
        fit streams chunks instead; ``comm``/``device`` place a stream
        input (a DNDarray brings its own).

        A fit cannot be traced into a fused program (``htt.fuse``,
        ``htt.autoshard``): each step's convergence test is read on the
        host, so under a trace it raises ``FuseTraceError``.
        """
        require_concrete("KMeans.fit (its convergence test is read on the host each step)")
        from ..io import stream as _stream

        if isinstance(x, _stream.StreamSource) or self.mini_batch is not None:
            return self._fit_minibatch(x, resume, comm=comm, device=device)
        sanitize_in(x)
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
        arr = x.larray.to(torch.float32)
        comm = x.comm
        n, f = int(x.shape[0]), int(x.shape[1])
        k = self.n_clusters

        mode = None
        if x.split == 0 and comm.size > 1 and n % comm.size == 0:
            from ..comm import compressed as _cq

            mode = _cq.reduce_mode(torch.float32, k * f * 4)
        use_q = mode is not None

        from ..resilience import elastic as _elastic

        meta = {"n": n, "f": f, "k": k, "tol": float(self.tol), "max_iter": int(self.max_iter)}
        splits = {"it": None, "centers": None, "shift": None}
        if use_q:
            meta.update(mode=mode)
            splits["error"] = "mesh"
        ckpt = self._checkpointer("kmeans-q" if use_q else "kmeans", meta, comm=comm, splits=splits)

        dev = arr.device
        if resume:
            state, _ = ckpt.load(elastic=resume == "elastic")
            carry = (
                int(state["it"]),
                torch.as_tensor(state["centers"], dtype=torch.float32).to(dev),
                float(state["shift"]),
            )
            if use_q:
                carry += (torch.as_tensor(state["error"], dtype=torch.float32).to(dev),)
        else:
            self._initialize_cluster_centers(x)
            carry = (0, self._cluster_centers.larray.to(torch.float32), float("inf"))
            if use_q:
                carry += (torch.zeros((comm.size, k * f), dtype=torch.float32, device=dev),)

        # the reference compares in float32: tol rounds as it does there
        tol = float(np.float32(self.tol))
        if use_q:
            p = comm.size
            blocks = arr.reshape(p, n // p, f)
        while True:
            it0 = carry[0]
            stop = ckpt.stop(it0, self.max_iter)
            with _elastic.dispatch_guard("kmeans.seg_q" if use_q else "kmeans.seg", comm):
                if use_q:
                    seg = jitted(("kmeans.seg_q", comm, mode, n, f, k), lambda: KMeans._fit_segment_q)
                    carry = seg(blocks, tol, stop, carry, mode=mode)
                else:
                    carry = KMeans._fit_segment(arr, tol, stop, carry)
            it = carry[0]
            if use_q and _tel.enabled and it > it0:
                from ..comm import compressed as _cq

                # the loop runs its rings on the ring primitive, below
                # allreduce_q's accounting: one ledger entry a segment
                _cq._account_wire("allreduce", mode, k * f, comm.size, reps=it - it0)
            if it >= self.max_iter or it < stop:
                # out of iterations, or converged before the boundary
                break
            snap = {"it": np.int32(it), "centers": carry[1], "shift": np.float32(carry[2])}
            if use_q:
                snap["error"] = carry[3]
            ckpt.tick(it, snap)

        centers = carry[1]
        if use_q:
            labels, self._inertia = jitted(("kmeans.fin_q", comm, n, f, k), lambda: _labels_inertia)(
                arr, centers)
        else:
            labels, self._inertia = _labels_inertia(arr, centers)
        self._finalize_fit(x, centers, labels, carry[0])
        return self

    def _fit_minibatch(self, x, resume=False, comm=None, device=None) -> "KMeans":
        """Out-of-core mini-batch fit: ``max_iter`` epochs of incremental
        center updates over :func:`heat_tpu_torch.io.stream.stream_chunks`,
        the stream position in the carry ``(it, centers, counts)`` (``it //
        h`` the epoch, ``it % h`` the chunk).  Each update computes on the
        chunk's first ``mini_batch`` rows, a shape that no number of
        positions changes, so the trajectory is a pure function of the
        byte stream: a snapshot resumes on more or fewer positions
        (``resume="elastic"``) bitwise equal to an uninterrupted fit, and
        an in-memory twin of on-disk data reproduces the streamed fit
        exactly.  ``labels_`` and ``inertia_`` stay None (the data never
        sits on the device at once)."""
        from ..core import factories
        from ..io import stream as _stream
        from ..resilience import elastic as _elastic

        src = _stream.as_source(x)
        if isinstance(x, DNDarray):
            device = x.device if device is None else device
            comm = x.comm if comm is None else comm
        device, comm = factories._setup(device, comm)
        if len(src.shape) != 2:
            raise ValueError(f"input needs to be 2D, but was {len(src.shape)}D")
        if self.mini_batch is None:
            raise ValueError("streaming fit requires KMeans(mini_batch=<rows per chunk>)")
        n, f = src.shape
        k = self.n_clusters
        mb = self.mini_batch
        h = max(1, -(-n // mb))
        total = int(self.max_iter) * h

        meta = {"n": n, "f": f, "k": k, "mb": mb, "max_iter": int(self.max_iter)}
        splits = {"it": None, "centers": None, "counts": None}
        ckpt = self._checkpointer("kmeans-mb", meta, comm=comm, splits=splits)

        dev = comm.device
        if resume:
            state, _ = ckpt.load(elastic=resume == "elastic")
            carry = (
                int(state["it"]),
                torch.as_tensor(state["centers"], dtype=torch.float32).to(dev),
                torch.as_tensor(state["counts"], dtype=torch.float32).to(dev),
            )
        else:
            centers0 = self._init_minibatch_centers(src, n, f, k, mb)
            carry = (0, torch.as_tensor(centers0, dtype=torch.float32).to(dev),
                     torch.zeros((k, 1), dtype=torch.float32, device=dev))

        while True:
            it0 = carry[0]
            stop = ckpt.stop(it0, total)
            with _elastic.dispatch_guard("kmeans.mb", comm):
                for (chunk,), nv in _stream.stream_chunks(src, mb, it0, stop, comm=comm, device=device):
                    step = jitted(("kmeans.mb_seg", comm, mb, f, k), lambda: _kmeans_mb_step)
                    carry = step(chunk, nv, *carry, mb=mb, k=k)
            it = carry[0]
            if it >= total or it < stop:
                break
            ckpt.tick(it, {"it": np.int32(it), "centers": carry[1], "counts": carry[2]})

        self._n_iter = carry[0]
        self._cluster_centers = DNDarray(carry[1], (k, f), types.float32, None, device, comm)
        self._labels = None
        self._inertia = None
        return self

    def _init_minibatch_centers(self, src, n, f, k, mb):
        """Initial centers of a streaming fit: a DNDarray of centroids
        passes through; ``"random"`` draws k distinct rows of the first
        chunk with a host-side seeded numpy generator (``random_state``, 0
        when None): independent of the number of positions, and the
        reference's draw."""
        if isinstance(self.init, DNDarray):
            if tuple(self.init.shape) != (k, f):
                raise ValueError("passed centroids do not match cluster count or data shape")
            return self.init.resplit(None).numpy().astype(np.float32)
        if self.init == "random":
            nv0 = min(mb, n)
            if k > nv0:
                raise ValueError(
                    f"n_clusters={k} exceeds the first chunk's {nv0} rows; "
                    "raise mini_batch or pass explicit centroids"
                )
            rng = np.random.default_rng(0 if self.random_state is None else int(self.random_state))
            idx = np.sort(rng.choice(nv0, size=k, replace=False))
            block = np.asarray(src.read(0, nv0), dtype=np.float32)
            return block[idx]
        raise ValueError(
            "mini-batch/streaming fits support init='random' or an explicit "
            f"DNDarray of centroids, got {self.init!r}"
        )


def _kmeans_mb_step(chunk: torch.Tensor, nvalid: int, it: int, centers: torch.Tensor,
                    counts: torch.Tensor, *, mb: int, k: int):
    """One chunk update of the mini-batch fit: ``(it, centers, counts) ->
    (it + 1, centers', counts')``.  It reads the chunk's first ``mb`` rows
    (the pads of a wider chunk are beyond them), and the row mask
    ``arange(mb) < nvalid`` zeroes every pad row's part in the batch sums
    and counts, the ragged last chunk's included."""
    x = chunk[:mb]
    w = (torch.arange(mb, device=x.device) < nvalid).to(x.dtype)
    labels = _assign(x, centers)
    sel = _one_hot(labels, k, x.dtype) * w[:, None]
    bsums = torch.matmul(sel.T, x)
    bcounts = torch.sum(sel, dim=0)[:, None]
    counts2 = counts + bcounts
    # running-mean pull toward the batch mean, weighted by each center's
    # lifetime count: c += (bsum - bcount c) / total
    nc = torch.where(
        bcounts > 0.0,
        centers + (bsums - bcounts * centers) / torch.clamp_min(counts2, 1.0),
        centers,
    )
    return it + 1, nc, counts2

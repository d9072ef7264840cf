"""Lasso: L1-regularised linear regression.

Port of ``heat_tpu/regression/lasso.py``: cyclic coordinate descent
(``solver="cd"``) and proximal gradient, ISTA (``solver="gd"``), each
with an unregularised intercept.  Under a compressing collective policy
on a row-split input whose rows divide over several positions, each ISTA
step's per-position gradient partials ``A_p^T (A_p theta - y_p)`` combine
on the block-scaled quantized ring with an error-feedback residual in the
loop carry (:func:`heat_tpu_torch.comm.compressed.ring_allreduce_q_ef`),
so quantization adds noise to the iterates but no bias.

The design matrix is held once per fit as ``(m, n)`` columns, the
intercept's row of ones first: coordinate j reads one contiguous row, and
the position blocks of a row-split input are its column blocks.  The fit
stays on the device: the host reads one scalar a sweep (or a step) for the
``delta > tol`` test, and the fitted theta is a device array.  A
coordinate update keeps the residual incremental (``resid -= x_j *
delta_j``) and computes ``rho_j = mean(x_j * (resid + x_j theta_j))`` as
``(x_j . resid + theta_j |x_j|^2) / n``.

With telemetry on, the quantized ISTA loop credits the byte ledger with
each segment's rings in one entry, as the reference's does.

``checkpoint_every=N`` runs each loop in N-sweep (step) segments,
snapshotting the carry (the stacked error-feedback residual included)
between them; ``fit(..., resume=True)`` continues bitwise where the
snapshot left off, ``resume="elastic"`` also onto another number of
positions.  ``mini_batch=`` (gd only) or stream-source inputs fit out of
core: ISTA steps over the chunks of
:func:`heat_tpu_torch.io.stream.stream_chunks`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import factories, types
from ..core.base import BaseEstimator, RegressionMixin
from ..core._tracing import record_dispatch, require_concrete
from ..core.dndarray import DNDarray
from ..core.fuse import fuse
from ..core.sanitation import sanitize_in, sanitize_predict_in
from ..telemetry import _core as _tel
from ..core._split_semantics import split_semantics as _split_semantics

__all__ = ["Lasso"]

#: power-iteration steps of the ISTA step size
_POWER_STEPS = 50


def _fma_chain(arr: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """``[1, arr] @ th`` as the reference's compiled CPU program sums it
    (XLA's loop fusion of the dot, for up to 33 terms): one float32 fused
    multiply-add per term, first to last, each emulated in float64 (where
    the product of two float32 values is exact) and rounded to float32."""
    acc = th[0].expand(arr.shape[0])
    for j in range(arr.shape[1]):
        acc = (arr[:, j].double() * th[j + 1].double() + acc.double()).to(torch.float32)
    return acc


def _lasso_predict_program(x: DNDarray, theta: DNDarray) -> DNDarray:
    """``y = theta_0 + x @ theta_1:`` as one program, so a warm predict is
    one dispatch (one CUDA-graph replay on the card).  On the CPU the sum
    runs in the reference's FMA order, so a served reply is bitwise the
    reference's; on the card it is one ``addmv``."""
    th = theta.larray.reshape(-1)
    arr = x.larray.to(torch.float32)
    if arr.device.type == "cpu":
        pred = _fma_chain(arr, th).reshape(-1, 1)
    else:
        pred = torch.addmv(th[:1], arr, th[1:]).reshape(-1, 1)
    return DNDarray(pred, (x.shape[0], 1), types.float32, x.split, x.device, x.comm)


_fused_lasso_predict = fuse(_lasso_predict_program)


class Lasso(RegressionMixin, BaseEstimator):
    """Lasso estimator.

    Parameters
    ----------
    lam : float — L1 penalty weight.
    max_iter : int — coordinate-descent sweeps (or gradient steps).
    tol : float — convergence threshold on the largest coefficient change
        of a sweep (step); ``tol < 0`` runs exactly ``max_iter``.
    solver : str — ``"cd"`` (default): cyclic coordinate descent; ``"gd"``:
        ISTA with a power-iteration step size, whose gradient combine rides
        the compressed ring under a compressing collective policy.
    checkpoint_every : int — snapshot the fit loop's carry every N sweeps
        (steps); 0, the default, never.  A fit killed at a segment boundary
        and restarted with ``fit(..., resume=True)`` replays the identical
        float trajectory; the quantized gd snapshots its error-feedback
        residual too.
    checkpoint_path : str or None — the HDF5 snapshot (atomic writes;
        required when ``checkpoint_every > 0``).
    mini_batch : int or None — rows per chunk of the out-of-core fit (gd
        only): ``max_iter`` counts epochs over a fixed chunk schedule,
        ``tol`` is not used, and the ISTA step comes from a power
        iteration on the first chunk.
    """

    def __init__(
        self,
        lam: float = 0.1,
        max_iter: int = 100,
        tol: float = 1e-6,
        solver: str = "cd",
        checkpoint_every: int = 0,
        checkpoint_path: Optional[str] = None,
        mini_batch: Optional[int] = None,
    ):
        if solver not in ("cd", "gd"):
            raise ValueError(f"solver must be 'cd' or 'gd', got {solver!r}")
        if mini_batch is not None:
            if solver != "gd":
                raise ValueError(
                    "mini_batch streaming requires solver='gd' (coordinate "
                    "descent sweeps every column over all rows at once)"
                )
            if int(mini_batch) < 1:
                raise ValueError(f"mini_batch must be >= 1, got {mini_batch}")
        self.mini_batch = None if mini_batch is None else int(mini_batch)
        self.__lam = lam
        self.max_iter = max_iter
        self.tol = tol
        self.solver = solver
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        self.__theta = None
        self.n_iter = None

    def _checkpoint_attrs(self):
        # fitted state is the name-mangled theta plus the sweep count
        return ["_Lasso__theta", "n_iter"]

    def _checkpointer(self, algo: str, meta: dict, comm=None, splits=None):
        """The loop-snapshot driver of this fit configuration."""
        from ..resilience.resume import LoopCheckpointer

        return LoopCheckpointer(
            self.checkpoint_path, self.checkpoint_every, algo, meta, comm=comm, splits=splits,
        )

    @property
    def lam(self) -> float:
        return self.__lam

    @lam.setter
    def lam(self, arg: float):
        self.__lam = arg

    @property
    def coef_(self) -> Optional[DNDarray]:
        """The fitted coefficients, ``(f, 1)``."""
        return None if self.__theta is None else self.__theta[1:]

    @property
    def intercept_(self) -> Optional[DNDarray]:
        """The fitted intercept, ``(1,)``."""
        return None if self.__theta is None else self.__theta[0]

    @property
    def theta(self) -> Optional[DNDarray]:
        """Intercept and coefficients, ``(f + 1, 1)``."""
        return self.__theta

    @staticmethod
    def soft_threshold(rho: torch.Tensor, lam: float) -> torch.Tensor:
        """The shrinkage operator ``sign(rho) * max(|rho| - lam, 0)``."""
        return F.softshrink(rho, float(lam))

    def rmse(self, gt: DNDarray, yest: DNDarray) -> float:
        """Root-mean-square error of ``yest`` against ``gt``."""
        diff = gt.larray.reshape(-1) - yest.larray.reshape(-1)
        return float(torch.sqrt(torch.mean(diff * diff)))

    @classmethod
    def from_fitted(cls, theta, n_iter: Optional[int] = None, lam: float = 0.1,
                    device=None, comm=None, **params) -> "Lasso":
        """A fitted estimator from numpy state, e.g. read off a Lasso fitted
        by the JAX package: ``theta`` (intercept first, ``(f + 1,)`` or
        ``(f + 1, 1)``) and the iteration count, ready to ``predict``."""
        est = cls(lam=lam, **params)
        th = np.asarray(theta, dtype=np.float32).reshape(-1, 1)
        est.__theta = factories.array(th, device=device, comm=comm)
        est.n_iter = None if n_iter is None else int(n_iter)
        return est

    @_split_semantics("entry_fit")
    def fit(self, x, y, resume=False, comm=None, device=None) -> "Lasso":
        """Fit on ``x`` (``(n, f)``) and ``y`` (``(n,)`` or ``(n, 1)``).

        With ``checkpoint_every=N`` the loop runs in N-sweep (step)
        segments, snapshotting the carry between them; ``resume=True``
        restarts from the snapshot and finishes bitwise equal to an
        uninterrupted fit; ``resume="elastic"`` also takes a snapshot of
        another number of positions.  With ``mini_batch=`` set, or stream
        sources as inputs, the gd fit streams chunks instead;
        ``comm``/``device`` place stream inputs (DNDarrays bring their
        own).  A fit cannot be traced into a fused program: each sweep's
        convergence test is read on the host, so under a trace it raises
        ``FuseTraceError``."""
        require_concrete("Lasso.fit (its convergence test is read on the host each sweep)")
        from ..core import _xproc
        from ..io import stream as _stream

        _xproc.refuse_across("Lasso.fit", comm, *[a for a in (x, y) if isinstance(a, DNDarray)])

        if (
            isinstance(x, _stream.StreamSource)
            or isinstance(y, _stream.StreamSource)
            or self.mini_batch is not None
        ):
            return self._fit_minibatch_gd(x, y, resume, comm=comm, device=device)
        sanitize_in(x)
        sanitize_in(y)
        if x.ndim != 2:
            raise ValueError(f"x needs to be 2D, but was {x.ndim}D")
        if y.ndim > 2 or (y.ndim == 2 and y.shape[1] != 1):
            raise ValueError("y needs to be 1D or a single column")
        n, f = x.shape
        xs = x.larray
        cols = torch.empty((f + 1, n), dtype=torch.float32, device=xs.device)
        cols[0] = 1.0
        cols[1:] = xs.T
        yv = y.larray.reshape(-1).to(device=xs.device, dtype=torch.float32)
        if self.solver == "gd":
            theta, n_iter = self._fit_gd(x, cols, yv, resume)
        else:
            theta, n_iter = self._fit_cd(cols, yv, resume, comm=x.comm)
        self.n_iter = n_iter
        self.__theta = DNDarray(theta.reshape(-1, 1), (f + 1, 1), types.float32, None, x.device, x.comm)
        return self

    def _meta(self, n: int, m: int) -> dict:
        return {"n": n, "m": m, "lam": float(self.__lam), "tol": float(self.tol),
                "max_iter": int(self.max_iter)}

    def _resume_carry(self, ckpt, resume, device, stacked: bool = False):
        """The carry ``(it, theta, delta[, error])`` of a snapshot, on
        ``device``."""
        state, _ = ckpt.load(elastic=resume == "elastic")
        carry = (
            int(state["it"]),
            torch.as_tensor(state["theta"], dtype=torch.float32).to(device),
            float(state["delta"]),
        )
        if stacked:
            carry += (torch.as_tensor(state["error"], dtype=torch.float32).to(device),)
        return carry

    def _run_segments(self, ckpt, carry, total: int, site: str, comm, segment, after=None):
        """Drive ``segment(carry, stop)`` segment by segment up to
        ``total`` iterations, snapshotting the carry between segments;
        ``after(it0, it)`` runs after each segment."""
        from ..resilience import elastic as _elastic

        while True:
            it0 = carry[0]
            stop = ckpt.stop(it0, total)
            with _elastic.dispatch_guard(site, comm):
                carry = segment(carry, stop)
            it = carry[0]
            if after is not None:
                after(it0, it)
            if it >= total or it < stop:
                # out of iterations, or converged before the boundary
                return carry
            snap = {"it": np.int32(it), "theta": carry[1], "delta": np.float32(carry[2])}
            if len(carry) > 3:
                snap["error"] = carry[3]
            ckpt.tick(it, snap)

    def _fit_cd(self, cols: torch.Tensor, yv: torch.Tensor, resume, comm=None):
        """Cyclic coordinate descent: sweeps while ``it < max_iter`` and
        the last sweep moved a coefficient by more than ``tol``, in
        segments of ``checkpoint_every`` sweeps."""
        m, n = cols.shape
        ckpt = self._checkpointer(
            "lasso-cd", self._meta(n, m), comm=comm,
            splits={"it": None, "theta": None, "delta": None},
        )
        if resume:
            carry = self._resume_carry(ckpt, resume, cols.device)
        else:
            carry = (0, torch.zeros(m, dtype=torch.float32, device=cols.device), float("inf"))
        sumsq = torch.clamp_min(torch.sum(cols * cols, dim=1), n * 1e-12)
        nlam = n * float(self.__lam)
        # views made once: a sweep is host-bound, each op a launch
        x, ss = cols.unbind(0), sumsq.unbind(0)
        # the reference compares in float32: tol rounds as it does there
        tol = float(np.float32(self.tol))

        def segment(carry, stop):
            it, theta, delta = carry
            theta = theta.clone()
            th = theta.unbind(0)
            while it < stop and delta > tol:
                prev = theta.clone()
                old = prev.unbind(0)
                resid = torch.addmv(yv, cols.T, theta, alpha=-1.0)
                for j in range(m):
                    # n * rho_j; the intercept (j == 0) is not regularised
                    rho = torch.addcmul(torch.dot(x[j], resid), old[j], ss[j])
                    if j:
                        rho = Lasso.soft_threshold(rho, nlam)
                    torch.div(rho, ss[j], out=th[j])
                    resid.addcmul_(x[j], th[j] - old[j], value=-1.0)
                it += 1
                delta = float((theta - prev).abs().max())
            return it, theta, delta

        it, theta, _ = self._run_segments(ckpt, carry, int(self.max_iter), "lasso.cd", comm, segment)
        return theta, it

    @staticmethod
    def _lipschitz(cols: torch.Tensor) -> torch.Tensor:
        """lambda_max(A^T A) / n by power iteration: the ISTA step is 1/L."""
        g = (cols @ cols.T) / cols.shape[1]
        v = torch.ones(cols.shape[0], dtype=torch.float32, device=cols.device)
        for _ in range(_POWER_STEPS):
            w = g @ v
            v = w / torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
        return torch.clamp_min(v @ (g @ v), 1e-12)

    def _fit_gd(self, x: DNDarray, cols: torch.Tensor, yv: torch.Tensor, resume):
        """ISTA: ``theta <- prox(theta - step * grad)`` with ``step = 1/L``;
        exact, or with the gradient partials on the quantized EF ring; in
        segments of ``checkpoint_every`` steps."""
        from ..comm import compressed as _cq

        m, n = cols.shape
        comm = x.comm
        step = float(1.0 / Lasso._lipschitz(cols))
        thr = float(np.float32(step) * np.float32(self.__lam))
        tol = float(np.float32(self.tol))
        mode = None
        if x.split == 0 and comm.size > 1 and n % comm.size == 0:
            mode = _cq.reduce_mode(torch.float32, m * 4)
        meta = self._meta(n, m)
        splits = {"it": None, "theta": None, "delta": None}
        if mode is not None:
            p = comm.size
            blocks = comm.blocks(cols, 1)  # (p, m, n/p): position p's rows, as columns
            ckpt = self._checkpointer("lasso-gd-q", {**meta, "mode": mode}, comm=comm,
                                      splits={**splits, "error": "mesh"})
        else:
            ckpt = self._checkpointer("lasso-gd", meta, comm=comm, splits=splits)
        if resume:
            carry = self._resume_carry(ckpt, resume, cols.device, stacked=mode is not None)
        else:
            carry = (0, torch.zeros(m, dtype=torch.float32, device=cols.device), float("inf"))
            if mode is not None:
                carry += (torch.zeros((p, m), dtype=torch.float32, device=cols.device),)
        neg_y = -yv

        def segment(carry, stop):
            it, theta, delta = carry[:3]
            error = carry[3] if mode is not None else None
            while it < stop and delta > tol:
                resid = torch.addmv(neg_y, cols.T, theta)  # A theta - y, row by row
                if mode is None:
                    grad = torch.mv(cols, resid) / n
                else:
                    partials = torch.bmm(blocks, resid.view(p, -1, 1)).view(p, m)
                    total, error = _cq.ring_allreduce_q_ef(partials, error, size=p, mode=mode)
                    grad = total / n
                new = theta - step * grad
                new[1:] = Lasso.soft_threshold(new[1:], thr)
                delta = float((new - theta).abs().max())
                theta = new
                it += 1
            return (it, theta, delta) + ((error,) if mode is not None else ())

        def after(it0, it):
            if mode is not None and _tel.enabled and it > it0:
                # the ring primitive sits below allreduce_q's accounting:
                # one ledger entry for the segment's rings of m values
                _cq._account_wire("allreduce", mode, m, p, reps=it - it0)

        site = "lasso.gd_q" if mode is not None else "lasso.gd"
        if mode is not None:
            ring_segment = segment

            def segment(carry, stop):
                record_dispatch()  # a segment is one program (reference lasso.py:627)
                return ring_segment(carry, stop)

        carry = self._run_segments(ckpt, carry, int(self.max_iter), site, comm, segment, after)
        return carry[1], carry[0]

    def _fit_minibatch_gd(self, x, y, resume=False, comm=None, device=None) -> "Lasso":
        """Out-of-core proximal-gradient fit: ``max_iter`` epochs of ISTA
        steps over the chunks of :func:`heat_tpu_torch.io.stream.stream_chunks`,
        the stream position in the carry ``(it, theta, delta)``.

        The step is ``1/L`` from a power iteration over the first chunk's
        design matrix, recomputed on every (re)entry.  Each step computes
        on the chunk's first ``mini_batch`` rows, a shape no number of
        positions changes, with the row mask ``arange(mb) < nvalid`` as the
        intercept column: pad rows are zero in the design matrix and in
        ``y`` and add nothing to the gradient, so the trajectory is a pure
        function of the byte stream and an elastic resume is bitwise."""
        if self.mini_batch is None:
            raise ValueError("streaming fit requires Lasso(solver='gd', mini_batch=...)")
        from ..core import factories
        from ..io import stream as _stream

        for d in (x, y):
            if isinstance(d, DNDarray):
                device = d.device if device is None else device
                comm = d.comm if comm is None else comm
        device, comm = factories._setup(device, comm)
        srcx = _stream.as_source(x)
        srcy = _stream.as_source(y)
        if len(srcx.shape) != 2:
            raise ValueError(f"x needs to be 2D, but was {len(srcx.shape)}D")
        ynd = len(srcy.shape)
        if ynd > 2 or (ynd == 2 and srcy.shape[1] != 1):
            raise ValueError("y needs to be 1D or a single column")

        n, f = srcx.shape
        m = f + 1
        mb = self.mini_batch
        h = max(1, -(-n // mb))
        total = int(self.max_iter) * h
        dev = comm.device

        nv0 = min(mb, n)
        x0 = torch.as_tensor(np.asarray(srcx.read(0, nv0), dtype=np.float32)).to(dev)
        cols0 = torch.cat([torch.ones((1, nv0), dtype=torch.float32, device=dev), x0.T])
        step = float(1.0 / Lasso._lipschitz(cols0))
        thr = float(np.float32(step) * np.float32(self.__lam))

        meta = {"n": n, "m": m, "lam": float(self.__lam), "mb": mb, "max_iter": int(self.max_iter)}
        ckpt = self._checkpointer("lasso-mb", meta, comm=comm,
                                  splits={"it": None, "theta": None, "delta": None})
        if resume:
            carry = self._resume_carry(ckpt, resume, dev)
        else:
            carry = (0, torch.zeros(m, dtype=torch.float32, device=dev), float("inf"))
        rows = torch.arange(mb, device=dev)

        def segment(carry, stop):
            it, theta, delta = carry
            for (xc, yc), nv in _stream.stream_chunks(
                (srcx, srcy), mb, it, stop, comm=comm, device=device
            ):
                record_dispatch()  # a chunk step is one program (reference lasso.py:561)
                w = (rows < nv).to(torch.float32)
                a = torch.cat([w[:, None], xc[:mb]], dim=1)
                grad = a.T @ (a @ theta - yc[:mb].reshape(mb)) / float(nv)
                new = theta - step * grad
                new[1:] = Lasso.soft_threshold(new[1:], thr)
                delta = (new - theta).abs().max()
                theta = new
                it += 1
            return it, theta, float(delta)

        it, theta, _ = self._run_segments(ckpt, carry, total, "lasso.mb", comm, segment)
        self.n_iter = it
        self.__theta = DNDarray(theta.reshape(-1, 1), (m, 1), types.float32, None, device, comm)
        return self

    @_split_semantics("entry_split0")
    def predict(self, x: DNDarray) -> DNDarray:
        """``y = theta_0 + x @ theta_1:``, ``(n, 1)``, row-split when ``x``
        is."""
        if self.__theta is None:
            raise RuntimeError("fit() must be called before predict()")
        x = sanitize_predict_in(x, n_features=int(self.__theta.shape[0]) - 1, op="Lasso.predict")
        return _fused_lasso_predict(x, self.__theta)

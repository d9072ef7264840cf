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
all of its rings in one entry, as the reference's does.

Not ported: streaming ``mini_batch`` fits (ROADMAP queue A, item 12) and
``checkpoint_every``/``resume`` (item 16), which raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import factories, types
from ..core.base import BaseEstimator, RegressionMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in, sanitize_predict_in
from ..telemetry import _core as _tel

__all__ = ["Lasso"]

#: power-iteration steps of the ISTA step size
_POWER_STEPS = 50


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
    checkpoint_every, checkpoint_path : loop checkpointing (not ported yet:
        ``checkpoint_every > 0`` raises at ``fit``).
    mini_batch : int or None — out-of-core streaming (gd only; not ported
        yet: raises at ``fit``).
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

    def fit(self, x: DNDarray, y: DNDarray, resume=False) -> "Lasso":
        """Fit on ``x`` (``(n, f)``) and ``y`` (``(n,)`` or ``(n, 1)``)."""
        if self.mini_batch is not None:
            raise NotImplementedError(
                "mini_batch streaming fits need io/stream.py (ROADMAP queue A, item 12)"
            )
        if self.checkpoint_every or resume:
            raise NotImplementedError(
                "checkpoint_every/resume need the resilience layer (ROADMAP queue A, item 16)"
            )
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
        # the reference compares in float32: tol rounds as it does there
        tol = float(np.float32(self.tol))
        if self.solver == "gd":
            theta, n_iter = self._fit_gd(x, cols, yv, tol)
        else:
            theta, n_iter = self._fit_cd(cols, yv, tol)
        self.n_iter = n_iter
        self.__theta = DNDarray(theta.reshape(-1, 1), (f + 1, 1), types.float32, None, x.device, x.comm)
        return self

    def _fit_cd(self, cols: torch.Tensor, yv: torch.Tensor, tol: float):
        """Cyclic coordinate descent: sweeps while ``it < max_iter`` and
        the last sweep moved a coefficient by more than ``tol``."""
        m, n = cols.shape
        sumsq = torch.clamp_min(torch.sum(cols * cols, dim=1), n * 1e-12)
        nlam = n * float(self.__lam)
        theta = torch.zeros(m, dtype=torch.float32, device=cols.device)
        # views made once: a sweep is host-bound, each op a launch
        x, ss, th = cols.unbind(0), sumsq.unbind(0), theta.unbind(0)
        it = 0
        while it < self.max_iter:
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
            if not bool((theta - prev).abs().max() > tol):
                break
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

    def _fit_gd(self, x: DNDarray, cols: torch.Tensor, yv: torch.Tensor, tol: float):
        """ISTA: ``theta <- prox(theta - step * grad)`` with ``step = 1/L``;
        exact, or with the gradient partials on the quantized EF ring."""
        from ..comm import compressed as _cq

        m, n = cols.shape
        comm = x.comm
        step = float(1.0 / Lasso._lipschitz(cols))
        thr = float(np.float32(step) * np.float32(self.__lam))
        mode = None
        if x.split == 0 and comm.size > 1 and n % comm.size == 0:
            mode = _cq.reduce_mode(torch.float32, m * 4)
        if mode is not None:
            p = comm.size
            blocks = comm.blocks(cols, 1)  # (p, m, n/p): position p's rows, as columns
            error = torch.zeros((p, m), dtype=torch.float32, device=cols.device)

        theta = torch.zeros(m, dtype=torch.float32, device=cols.device)
        neg_y = -yv
        it = 0
        while it < self.max_iter:
            resid = torch.addmv(neg_y, cols.T, theta)  # A theta - y, row by row
            if mode is None:
                grad = torch.mv(cols, resid) / n
            else:
                partials = torch.bmm(blocks, resid.view(p, -1, 1)).view(p, m)
                total, error = _cq.ring_allreduce_q_ef(partials, error, size=p, mode=mode)
                grad = total / n
            new = theta - step * grad
            new[1:] = Lasso.soft_threshold(new[1:], thr)
            delta = (new - theta).abs().max()
            theta = new
            it += 1
            if not bool(delta > tol):
                break
        if mode is not None and _tel.enabled and it > 0:
            # the ring primitive sits below allreduce_q's accounting: one
            # ledger entry for the loop's ``it`` rings of m values
            _cq._account_wire("allreduce", mode, m, p, reps=it)
        return theta, it

    def predict(self, x: DNDarray) -> DNDarray:
        """``y = theta_0 + x @ theta_1:``, ``(n, 1)``, row-split when ``x``
        is."""
        if self.__theta is None:
            raise RuntimeError("fit() must be called before predict()")
        x = sanitize_predict_in(x, n_features=int(self.__theta.shape[0]) - 1, op="Lasso.predict")
        th = self.__theta.larray.reshape(-1).to(x.larray.device)
        pred = torch.addmv(th[:1], x.larray.to(torch.float32), th[1:]).reshape(-1, 1)
        return DNDarray(pred, (x.shape[0], 1), types.float32, x.split, x.device, x.comm)

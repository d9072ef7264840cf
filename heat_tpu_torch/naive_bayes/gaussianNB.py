"""Gaussian naive Bayes classification.

Port of ``heat_tpu/naive_bayes/gaussianNB.py``: per-class means and
variances from one-hot products on the device, in float64; the batches of
``partial_fit`` merge by the Chan/Golub/LeVeque update on the host (k
classes, float64); a variance floor of ``var_smoothing`` times the
largest feature variance of the batch.  Under a compressing collective
policy, a row-split batch over several positions takes its per-class
moments from :func:`heat_tpu_torch.comm.compressed.class_moments_q`:
exact counts and sums, the centered sums of squares on the quantized
ring.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in, sanitize_predict_in

__all__ = ["GaussianNB"]


class GaussianNB(ClassificationMixin, BaseEstimator):
    """Gaussian naive Bayes.

    Parameters
    ----------
    priors : array-like of shape (n_classes,), optional
    var_smoothing : float — share of the largest feature variance added
        to every variance
    """

    def __init__(self, priors=None, var_smoothing: float = 1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing
        self.classes_ = None
        self.theta_ = None
        self.sigma_ = None
        self.class_count_ = None
        self.class_prior_ = None
        self.epsilon_ = None

    @classmethod
    def from_fitted(cls, state: dict, priors=None, var_smoothing: float = 1e-9) -> "GaussianNB":
        """A fitted estimator from numpy state — ``theta_``, ``sigma_``,
        ``class_prior_``, ``class_count_`` and ``classes_`` (and optionally
        ``epsilon_``), e.g. read off a GaussianNB fitted by the JAX package
        — ready to ``predict`` and to ``partial_fit`` further batches."""
        nb = cls(priors=priors, var_smoothing=var_smoothing)
        for name in ("theta_", "sigma_", "class_prior_", "class_count_"):
            setattr(nb, name, np.array(state[name], dtype=np.float64))
        nb.classes_ = np.asarray(state["classes_"])
        nb.epsilon_ = state.get("epsilon_")
        return nb

    def fit(self, x: DNDarray, y: DNDarray, sample_weight=None) -> "GaussianNB":
        """Fit from scratch on ``x`` (n, f) and labels ``y`` (n,)."""
        self.classes_ = None
        self.theta_ = None
        self.sigma_ = None
        self.class_count_ = None
        return self.partial_fit(x, y, classes=np.unique(y.numpy()), sample_weight=sample_weight)

    @staticmethod
    def _update_mean_variance(n_past, mu, var, n_new, new_mu, new_var):
        """Chan/Golub/LeVeque pairwise merge of two batches' moments."""
        if n_past == 0:
            return new_mu, new_var
        n_total = n_past + n_new
        total_mu = (n_new * new_mu + n_past * mu) / n_total
        ssd = var * n_past + n_new * new_var + (n_new * n_past / n_total) * (mu - new_mu) ** 2
        return total_mu, ssd / n_total

    def _init_classes(self, classes, n_features: int) -> None:
        if classes is None:
            raise ValueError("classes must be passed on the first call to partial_fit")
        self.classes_ = np.asarray(classes)
        k = len(self.classes_)
        self.theta_ = np.zeros((k, n_features))
        self.sigma_ = np.zeros((k, n_features))
        self.class_count_ = np.zeros(k)
        if self.priors is None:
            self.class_prior_ = np.zeros(k)
            return
        priors = np.asarray(
            self.priors.numpy() if isinstance(self.priors, DNDarray) else self.priors, dtype=np.float64
        )
        if len(priors) != k:
            raise ValueError("Number of priors must match number of classes.")
        if not np.isclose(priors.sum(), 1.0):
            raise ValueError("The sum of the priors should be 1.")
        if (priors < 0).any():
            raise ValueError("Priors must be non-negative.")
        self.class_prior_ = priors

    def _batch_moments(self, x: DNDarray, arr: torch.Tensor, member: torch.Tensor):
        """The batch's per-class ``(counts, sums, sqsums)`` on the host."""
        k, f = member.shape[1], int(x.shape[1])
        if x.split == 0 and x.comm.size > 1 and int(x.shape[0]) % x.comm.size == 0:
            from ..comm import compressed as _cq

            mode = _cq.reduce_mode(x._buffer.dtype, 2 * k * f * 4)
            if mode is not None:
                cnts, qsums, qssd = _cq.class_moments_q(
                    x.larray, member.to(torch.float32), comm=x.comm, mode=mode
                )
                counts = cnts.double().cpu().numpy()
                sums = qsums.double().cpu().numpy()
                # the raw sums of squares the merge expects, exact in float64
                sq = qssd.double().cpu().numpy() + sums**2 / np.maximum(counts, 1.0)[:, None]
                return counts, sums, sq
        counts = torch.sum(member, dim=0).cpu().numpy()
        sums = (member.T @ arr).cpu().numpy()
        sq = (member.T @ (arr * arr)).cpu().numpy()
        return counts, sums, sq

    def partial_fit(self, x: DNDarray, y: DNDarray, classes=None, sample_weight=None) -> "GaussianNB":
        """Fit one more batch; ``classes`` (every label the fit will see)
        is required on the first call."""
        sanitize_in(x)
        sanitize_in(y)
        if x.ndim != 2:
            raise ValueError(f"expected x to be 2D, is {x.ndim}D")
        arr = x.larray.to(torch.float64)
        yv = y.numpy().reshape(-1)
        if self.classes_ is None:
            self._init_classes(classes, int(x.shape[1]))
        elif classes is not None and not np.array_equal(np.asarray(classes), self.classes_):
            raise ValueError("classes is not the same as on last call to partial_fit")

        # the variance floor from this batch
        self.epsilon_ = self.var_smoothing * float(torch.max(torch.var(arr, dim=0, unbiased=False)))
        if np.any(self.class_count_ > 0):
            self.sigma_ -= self.epsilon_

        unique_y = np.unique(yv)
        if not np.all(np.isin(unique_y, self.classes_)):
            raise ValueError(
                f"The target label(s) {np.setdiff1d(unique_y, self.classes_)} in y "
                f"do not exist in the initial classes {self.classes_}"
            )
        k = len(self.classes_)
        class_idx = torch.as_tensor(np.searchsorted(self.classes_, yv), device=arr.device)
        member = F.one_hot(class_idx, k).to(torch.float64)
        if sample_weight is not None:
            sw = sample_weight.numpy() if isinstance(sample_weight, DNDarray) else sample_weight
            sw = torch.as_tensor(np.asarray(sw, dtype=np.float64).reshape(-1), device=arr.device)
            member = member * sw[:, None]
        n_new_k, sums, sqsums = self._batch_moments(x, arr, member)

        for ci in range(k):
            n_new = float(n_new_k[ci])
            if n_new <= 0:
                continue
            new_mu = sums[ci] / n_new
            new_var = np.maximum(sqsums[ci] / n_new - new_mu**2, 0.0)
            mu, var = GaussianNB._update_mean_variance(
                self.class_count_[ci], self.theta_[ci], self.sigma_[ci], n_new, new_mu, new_var
            )
            self.theta_[ci] = mu
            self.sigma_[ci] = var
            self.class_count_[ci] += n_new

        self.sigma_ += self.epsilon_
        if self.priors is None:
            total = self.class_count_.sum()
            self.class_prior_ = self.class_count_ / total if total > 0 else self.class_count_
        return self

    # ------------------------------------------------------------------ #
    def _joint_log_likelihood(self, x: DNDarray, op: str):
        """``(x, jll)``: ``log P(c) + sum_f log N(x_f | theta_cf,
        sigma_cf)`` per row and class, in float64."""
        if self.theta_ is None:
            raise RuntimeError("fit() must be called before predict()")
        x = sanitize_predict_in(x, n_features=self.theta_.shape[1], op=op)
        arr = x.larray.to(torch.float64)
        theta, sigma, prior = (
            torch.as_tensor(np.asarray(a, dtype=np.float64), device=arr.device)
            for a in (self.theta_, self.sigma_, self.class_prior_)
        )
        logprior = torch.log(torch.clamp_min(prior, 1e-300))
        n_ij = -0.5 * torch.sum(torch.log(2.0 * math.pi * sigma), dim=1)
        diff = arr[:, None, :] - theta[None, :, :]
        ll = n_ij[None, :] - 0.5 * torch.sum(diff**2 / sigma[None, :, :], dim=2)
        return x, logprior[None, :] + ll

    @staticmethod
    def _rows(x: DNDarray, garr: torch.Tensor) -> DNDarray:
        split = x.split if x.split == 0 else None
        return DNDarray(garr, tuple(garr.shape), types.canonical_heat_type(garr.dtype), split, x.device, x.comm)

    def predict(self, x: DNDarray) -> DNDarray:
        """The class of largest posterior for each row."""
        x, jll = self._joint_log_likelihood(x, "GaussianNB.predict")
        classes = torch.as_tensor(np.asarray(self.classes_), device=jll.device)
        return self._rows(x, classes[torch.argmax(jll, dim=1)])

    def predict_log_proba(self, x: DNDarray) -> DNDarray:
        """Normalized log posteriors, float32."""
        x, jll = self._joint_log_likelihood(x, "GaussianNB.predict_log_proba")
        return self._rows(x, (jll - torch.logsumexp(jll, dim=1, keepdim=True)).to(torch.float32))

    def predict_proba(self, x: DNDarray) -> DNDarray:
        """Posterior probabilities, float32."""
        x, jll = self._joint_log_likelihood(x, "GaussianNB.predict_proba")
        log_prob = (jll - torch.logsumexp(jll, dim=1, keepdim=True)).to(torch.float32)
        return self._rows(x, torch.exp(log_prob))

"""sklearn-style estimator API: ``BaseEstimator``, ``ClassificationMixin``,
``ClusteringMixin``, ``RegressionMixin``, ``is_classifier`` and
``is_regressor``.

Port of ``heat_tpu/core/base.py`` without its telemetry span wrapping.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict

__all__ = [
    "BaseEstimator",
    "ClassificationMixin",
    "ClusteringMixin",
    "RegressionMixin",
    "is_classifier",
    "is_regressor",
]


class BaseEstimator:
    """Base class of every estimator: introspective parameters."""

    @classmethod
    def _parameter_names(cls):
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return sorted(
            p.name
            for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        )

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        """Parameters of this estimator."""
        params = {}
        for name in self._parameter_names():
            value = getattr(self, name, None)
            if deep and hasattr(value, "get_params"):
                for sub_name, sub_value in value.get_params().items():
                    params[f"{name}__{sub_name}"] = sub_value
            params[name] = value
        return params

    def set_params(self, **params) -> "BaseEstimator":
        """Set estimator parameters (``name__sub`` reaches nested ones)."""
        if not params:
            return self
        valid = self.get_params(deep=True)
        nested = {}
        for key, value in params.items():
            key, delim, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(f"Invalid parameter {key} for estimator {self}")
            if delim:
                nested.setdefault(key, {})[sub_key] = value
            else:
                setattr(self, key, value)
                valid[key] = value
        for key, sub_params in nested.items():
            getattr(self, key).set_params(**sub_params)
        return self

    def __repr__(self, N_CHAR_MAX: int = 700) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in sorted(self.get_params(deep=False).items()))
        return f"{self.__class__.__name__}({params})"[:N_CHAR_MAX]


class ClassificationMixin:
    """Mixin for classification estimators."""

    _estimator_type = "classifier"

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        """Fit, then return the predicted classes of ``x``."""
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


class ClusteringMixin:
    """Mixin for clustering estimators."""

    _estimator_type = "clusterer"

    def fit(self, x):
        raise NotImplementedError()

    def fit_predict(self, x):
        """Fit, then return the cluster labels of ``x``."""
        self.fit(x)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


class RegressionMixin:
    """Mixin for regression estimators."""

    _estimator_type = "regressor"

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        """Fit, then return the predictions for ``x``."""
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


def is_classifier(obj) -> bool:
    """True for a classification estimator."""
    return getattr(obj, "_estimator_type", None) == "classifier"


def is_regressor(obj) -> bool:
    """True for a regression estimator."""
    return getattr(obj, "_estimator_type", None) == "regressor"

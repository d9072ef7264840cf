"""sklearn-style estimator API: ``BaseEstimator``, ``ClassificationMixin``,
``ClusteringMixin``, ``RegressionMixin``, ``TransformMixin`` and the
``is_*`` predicates.

Port of ``heat_tpu/core/base.py``, with its telemetry span wrapping:
every subclass's ``fit``/``predict`` reports a ``fit:<Class>`` /
``predict:<Class>`` span under the class it is called on.
"""

from __future__ import annotations

import functools
import inspect
import types as _types
from typing import Any, Dict

from ..telemetry import _core as _tel

__all__ = [
    "BaseEstimator",
    "ClassificationMixin",
    "ClusteringMixin",
    "RegressionMixin",
    "TransformMixin",
    "is_classifier",
    "is_clusterer",
    "is_estimator",
    "is_regressor",
    "is_transformer",
]


def _spanned_method(meth, label: str):
    """Wrap an estimator entry point in a telemetry span.

    The wrapper is a single flag predicate per call while telemetry is
    disabled; enabled, every ``fit``/``predict`` lands in the per-site
    span aggregates under ``fit:<ClassName>`` / ``predict:<ClassName>``
    (the class is resolved at call time, so subclasses inheriting a
    wrapped method report under their own name)."""

    @functools.wraps(meth)
    def wrapper(self, *args, **kwargs):
        if not _tel.enabled:
            return meth(self, *args, **kwargs)
        with _tel.span(f"{label}:{type(self).__name__}"):
            return meth(self, *args, **kwargs)

    wrapper._telemetry_wrapped = True
    return wrapper


class BaseEstimator:
    """Base class of every estimator: introspective parameters."""

    def __init_subclass__(cls, **kwargs):
        # every concrete estimator's fit/predict emits a telemetry span
        # automatically — no per-estimator instrumentation to forget
        super().__init_subclass__(**kwargs)
        for name in ("fit", "predict"):
            meth = cls.__dict__.get(name)
            if (
                isinstance(meth, _types.FunctionType)
                and not getattr(meth, "_telemetry_wrapped", False)
            ):
                setattr(cls, name, _spanned_method(meth, name))

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

    def _checkpoint_attrs(self):
        """Instance attributes :func:`heat_tpu_torch.save_estimator` keeps
        besides the constructor parameters: by default every public ``*_``
        attribute (the sklearn fitted convention); estimators whose fitted
        state lives in private storage override it."""
        return [n for n in vars(self) if n.endswith("_") and not n.startswith("_")]

    def save(self, path: str) -> None:
        """Checkpoint this estimator (parameters and fitted state) to one
        HDF5 file: :func:`heat_tpu_torch.save_estimator`."""
        from .checkpoint import save_estimator

        save_estimator(self, path)

    @classmethod
    def load(cls, path: str) -> "BaseEstimator":
        """Restore an estimator saved with :meth:`save` (by either
        package); raises TypeError if the file holds another class than
        ``cls`` (``BaseEstimator.load`` accepts any)."""
        from .checkpoint import load_estimator

        est = load_estimator(path)
        if cls is not BaseEstimator and not isinstance(est, cls):
            raise TypeError(f"{path} holds a {type(est).__name__}, not a {cls.__name__}")
        return est


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


class TransformMixin:
    """Mixin for transformers: ``fit``/``transform``."""

    def fit(self, x):
        raise NotImplementedError()

    def transform(self, x):
        raise NotImplementedError()

    def fit_transform(self, x):
        """Fit, then return the transform of ``x``."""
        self.fit(x)
        return self.transform(x)


def is_estimator(obj) -> bool:
    """True for an estimator."""
    return isinstance(obj, BaseEstimator)


def is_classifier(obj) -> bool:
    """True for a classification estimator."""
    return getattr(obj, "_estimator_type", None) == "classifier"


def is_regressor(obj) -> bool:
    """True for a regression estimator."""
    return getattr(obj, "_estimator_type", None) == "regressor"


def is_clusterer(obj) -> bool:
    """True for a clustering estimator."""
    return getattr(obj, "_estimator_type", None) == "clusterer"


def is_transformer(obj) -> bool:
    """True for a transformer."""
    return isinstance(obj, TransformMixin)

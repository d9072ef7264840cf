"""Core: types, devices, the communicator, DNDarray, factories and ops."""

from . import types
from .arithmetics import *  # noqa: F401,F403
from .base import BaseEstimator, ClusteringMixin
from .communication import TorchCommunication, comm_for_device, get_comm, sanitize_comm, use_comm
from .devices import cpu, get_device, gpu, sanitize_device, use_device
from .dndarray import DNDarray
from .factories import *  # noqa: F401,F403
from .statistics import *  # noqa: F401,F403
from .types import bfloat16, bool, float16, float32, float64, int32, int64, promote_types

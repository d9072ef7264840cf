"""Core: types, devices, the communicator, DNDarray, ``fuse``, factories,
ops and linear algebra (the flat namespace of
``heat_tpu/core/__init__.py``)."""

from .communication import *  # noqa: F401,F403
from .devices import Device, cpu, get_device, gpu, sanitize_device, use_device
from . import types
from .types import *  # noqa: F401,F403
from .constants import *  # noqa: F401,F403
from .stride_tricks import *  # noqa: F401,F403
from .memory import *  # noqa: F401,F403
from . import sanitation
from .sanitation import *  # noqa: F401,F403
from .dndarray import *  # noqa: F401,F403
from . import fuse as _fuse_module
from .fuse import *  # noqa: F401,F403
from . import factories
from .factories import *  # noqa: F401,F403
from . import arithmetics
from .arithmetics import *  # noqa: F401,F403
from . import relational
from .relational import *  # noqa: F401,F403
from . import logical
from .logical import *  # noqa: F401,F403
from . import exponential
from .exponential import *  # noqa: F401,F403
from . import trigonometrics
from .trigonometrics import *  # noqa: F401,F403
from . import rounding
from .rounding import *  # noqa: F401,F403
from . import statistics
from .statistics import *  # noqa: F401,F403
from . import manipulations
from .manipulations import *  # noqa: F401,F403
from . import indexing
from .indexing import *  # noqa: F401,F403
from . import printing
from .printing import get_printoptions, set_printoptions
from .base import *  # noqa: F401,F403
from . import random
from . import tiling
from .tiling import *  # noqa: F401,F403
from . import linalg
from .linalg import *  # noqa: F401,F403
from . import io
from .io import *  # noqa: F401,F403
from . import checkpoint
from .checkpoint import *  # noqa: F401,F403

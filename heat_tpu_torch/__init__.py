"""heat_tpu_torch — the PyTorch/CUDA port of heat_tpu.

The analytics path of the JAX package on PyTorch: split DNDarrays over a
communicator's positions, factories, the threefry RNG, the op engine and
elementwise maps, mean/var/std, distances, linear algebra (matmul, QR,
SVD, cg, lanczos), graph Laplacians, the estimators (KMeans, KMedians,
KMedoids, Spectral, Lasso, GaussianNB, KNN), with the block-scaled int8
collectives as hand-written CUDA
kernels for Hopper (``csrc/``); and attention (``parallel``): flash,
ring and Ulysses attention on the hand-written flash kernels.  Arrays live on the GPU by default; the
CPU is used only when asked for (``use_device("cpu")``, ``device="cpu"``
or a communicator of CPU positions).

Float32 matrix products run at full float32 precision (TF32 off), the
reference's ``"highest"`` default that every parity check assumes.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from . import core  # noqa: E402
from .core import *  # noqa: E402,F401,F403
from .core import types  # noqa: E402
from . import comm  # noqa: E402
from . import classification  # noqa: E402
from . import cluster  # noqa: E402
from . import graph  # noqa: E402
from . import naive_bayes  # noqa: E402
from . import regression  # noqa: E402
from . import spatial  # noqa: E402
from . import parallel  # noqa: E402
from . import interop  # noqa: E402

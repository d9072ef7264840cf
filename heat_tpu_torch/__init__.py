"""heat_tpu_torch — the PyTorch/CUDA port of heat_tpu.

The analytics path of the JAX package on PyTorch: split DNDarrays over a
communicator's positions, factories, the threefry RNG, the op engine and
elementwise maps, statistics and order statistics, manipulations
(sort, unique, topk, reshape, ...), array keys, distances, linear algebra (matmul, QR,
SVD, cg, lanczos), graph Laplacians, the estimators (KMeans, KMedians,
KMedoids, Spectral, Lasso, GaussianNB, KNN), with the block-scaled int8
collectives as hand-written CUDA
kernels for Hopper (``csrc/``); and attention (``parallel``): flash,
ring and Ulysses attention on the hand-written flash kernels; and the base
layer beneath them (``telemetry``: spans, counters, the byte ledger,
histograms, SLOs, the flight recorder, Perfetto export and ``/metrics``;
``resilience``: incidents, retries, seeded fault injection, the
collective guards, loop snapshots with strict and elastic resume); file
IO (``io``: HDF5, NetCDF-3, CSV on a native scanner, and the out-of-core
stream the mini-batch fits consume), estimator checkpoints
(``save_estimator``/``load_estimator``) and the bundled ``datasets``; and
in-process serving (``serve``: the model registry, the micro-batcher,
the engine of fused predicts and the seeded load generator) with the
replica RPC framing (``net.wire``).  Arrays live on the GPU by default; the
CPU is used only when asked for (``use_device("cpu")``, ``device="cpu"``
or a communicator of CPU positions).

Float32 matrix products run at full float32 precision (TF32 off), the
reference's ``"highest"`` default that every parity check assumes.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .version import __version__  # noqa: E402
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
from . import utils  # noqa: E402
from . import telemetry  # noqa: E402
from . import resilience  # noqa: E402
from . import obs  # noqa: E402
from . import datasets  # noqa: E402
from . import net  # noqa: E402
from . import serve  # noqa: E402

# htt.io is the io PACKAGE (the flat loaders re-exported, and the stream):
# `from .core import *` bound the name to the flat core.io module, so the
# absolute import forces the package's load, which rebinds `io` here
import heat_tpu_torch.io  # noqa: E402,F401

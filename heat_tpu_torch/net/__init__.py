"""heat_tpu_torch.net — the loopback-only network plane.

Every socket the package opens is an *operational* surface (the metrics
scrape), not a product surface: it carries unauthenticated internals.
The rule, as in ``heat_tpu.net``, is **loopback only**: binds to
non-loopback hosts are refused at construction time.

- ``_base`` — the bind-host policy (``check_loopback``) and the atomic
  daemon-thread HTTP server lifecycle (``LoopbackHTTPServer``).
- ``wire`` — length-prefixed framing for the replica RPC (JSON header
  + raw ndarray blobs, no pickle), blocking and asyncio flavors; frames
  are byte-identical to ``heat_tpu.net.wire``'s.
"""

from ._base import LOOPBACK_HOSTS, LoopbackHTTPServer, check_loopback
from . import wire

__all__ = ["LOOPBACK_HOSTS", "LoopbackHTTPServer", "check_loopback", "wire"]

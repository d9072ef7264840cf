"""Version information for heat_tpu_torch.

A copy of ``heat_tpu/version.py``: the port carries the version of the
package it ports.
"""

major: int = 0
"""Major version number."""
minor: int = 1
"""Minor version number."""
micro: int = 0
"""Micro (patch) version number."""
extension: str = None
"""Version extension tag (e.g. dev/rc); None for releases."""

if not extension:
    __version__ = "{}.{}.{}".format(major, minor, micro)
else:
    __version__ = "{}.{}.{}-{}".format(major, minor, micro, extension)

"""The host allocator settings a configuration states for its deployment.

A configuration may hold ``"host": {"mallopt": {<parameter>: <value>}}``:
glibc ``mallopt(3)`` parameters the deployment runs the program under,
applied to the benchmark's process before the program is loaded.  A
configuration without the key runs under glibc's defaults.  A setting the
C library does not take (no glibc, an unknown parameter, a value it
refuses) is an error: the run then measures another deployment than the
one its configuration states.
"""

from __future__ import annotations

import ctypes
import ctypes.util

#: glibc's ``mallopt`` parameter numbers (``malloc.h``)
MALLOPT = {"M_TRIM_THRESHOLD": -1, "M_MMAP_THRESHOLD": -3}


class HostSettingRefused(RuntimeError):
    pass


def apply(config: dict) -> dict:
    """Apply ``config["host"]["mallopt"]``; return what was set.

    Raises ``HostSettingRefused`` where a setting is not taken."""
    wanted = config.get("host", {}).get("mallopt", {})
    if not wanted:
        return {}
    name = ctypes.util.find_library("c")
    try:
        mallopt = ctypes.CDLL(name).mallopt
    except (OSError, TypeError, AttributeError) as e:
        raise HostSettingRefused(f"no mallopt in this C library ({name}): {e}") from e
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    for param, value in wanted.items():
        if param not in MALLOPT:
            raise HostSettingRefused(f"unknown mallopt parameter {param!r}")
        if mallopt(MALLOPT[param], int(value)) != 1:
            raise HostSettingRefused(f"mallopt({param}, {value}) refused by the C library")
    return dict(wanted)


"""Root conftest: run the tests on a virtual 8-device CPU mesh.

The environment must be set before JAX starts a backend, which is why it
lives here, ahead of every test module's imports.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import faulthandler as _fh  # noqa: E402

# Watchdog: dump all stacks if anything hangs for 300s.
_fh.dump_traceback_later(300, repeat=True)


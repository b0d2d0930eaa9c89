import hashlib
import os
import sys

# The tests run on the CPU backend with 8 virtual devices, so multi-device
# sharding is exercised without accelerator hardware.  Must be set before
# jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)
import jax

jax.config.update("jax_platforms", "cpu")
# NOTE: jax_enable_x64 is deliberately NOT forced here: the device code
# paths compute in f32 and must stay int32/f32-clean.  Tests that exercise
# f64 *host-side jax* math opt in locally via the `enable_x64` fixture below.

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from sperr_tpu.utils import compile_cache  # noqa: E402


def _cpu_type_tag() -> str:
    """Stable name for this host's CPU type.  XLA:CPU executables are
    compiled for the host's CPU features, and loading one built on another
    CPU type can crash the loader (observed: SIGSEGV in
    compilation_cache.get_executable_and_time), so each CPU type gets its
    own subdirectory of the default cache."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = [ln for ln in f if ln.startswith("flags")][0]
    except (OSError, IndexError):
        flags = "unknown"
    return "cpu-" + hashlib.sha1(flags.encode()).hexdigest()[:10]


compile_cache.enable(_REPO, _cpu_type_tag())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import pytest  # noqa: E402


@pytest.fixture
def enable_x64():
    """Opt-in f64 jax semantics for host-side f64 checks (never used by the
    production device path)."""
    import jax as _jax

    _jax.config.update("jax_enable_x64", True)
    yield
    _jax.config.update("jax_enable_x64", False)

"""Process hygiene for training launches (the olmax `run.sh` idiom,
in-process).

Two kinds of environment setup come before the first large allocation:

  * allocator — tcmalloc via LD_PRELOAD (needs a re-exec: the loader
    reads LD_PRELOAD before Python runs) + a large-alloc report
    threshold so multi-GB numpy buffers don't spam warnings;
  * env defaults — applied only where the caller left them unset.

The JAX launcher's per-platform `XLA_FLAGS` table has no PyTorch
counterpart and is left out.

Everything is idempotent and respectful of the caller's environment: a
variable the user already set is never overwritten.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional

# env defaults applied only when unset (user environment wins)
_ENV_DEFAULTS = {
    # numpy/torch host buffers of multi-GB corpora are expected, not a leak
    "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
}

_TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
)

# sentinel so a re-exec'd child doesn't re-exec forever
_REEXEC_GUARD = "REPRO_TORCH_TCMALLOC_REEXECED"


def find_tcmalloc() -> Optional[str]:
    for p in _TCMALLOC_PATHS:
        if os.path.exists(p):
            return p
    return None


def maybe_reexec_tcmalloc(enable: bool) -> bool:
    """Re-exec the current process with tcmalloc LD_PRELOADed (the only
    way to swap the allocator: the dynamic loader consumed LD_PRELOAD
    before Python started). No-op (False) when disabled, already
    preloaded, already re-exec'd, or the library isn't installed. Call
    FIRST — before torch or any large allocation."""
    if not enable or os.environ.get(_REEXEC_GUARD):
        return False
    lib = find_tcmalloc()
    if lib is None or "tcmalloc" in os.environ.get("LD_PRELOAD", ""):
        return False
    env = dict(os.environ)
    env["LD_PRELOAD"] = (lib + (" " + env["LD_PRELOAD"]
                                if env.get("LD_PRELOAD") else ""))
    env[_REEXEC_GUARD] = "1"
    env.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                   _ENV_DEFAULTS["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"])
    os.execve(sys.executable, [sys.executable] + sys.argv, env)
    return True        # unreachable; keeps the signature honest


def apply_process_hygiene() -> Dict[str, str]:
    """Set the env defaults the caller left unset. Returns the variables
    actually changed (empty when the environment already had them)."""
    changed: Dict[str, str] = {}
    for k, v in _ENV_DEFAULTS.items():
        if k not in os.environ:
            os.environ[k] = v
            changed[k] = v
    return changed

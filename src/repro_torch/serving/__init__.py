"""The serving plane: batched endpoints + the multi-tenant frontend.

`ReadBatcher`/`ServeSession` (`serve_step`) are the single-tenant batch
endpoints over the query plane; `ServingFrontend` (`frontend`) is the
multi-tenant serving plane on top — continuous batching across N
archives, deadline/priority scheduling with typed `Overloaded`
backpressure, per-tenant cache partitions + TinyLFU admission
(`admission`), and the closed-loop traffic harness (`traffic`) that
turns its latency claims into measured p50/p95/p99 numbers.

Exports resolve lazily (PEP 562) so `python -m repro_torch.serving.traffic`
does not re-import its own module through the package.
"""
_EXPORTS = {
    "ServiceEstimator": "repro_torch.serving.admission",
    "TenantPartitionPolicy": "repro_torch.serving.admission",
    "Overloaded": "repro_torch.serving.frontend",
    "ReadCorrupt": "repro_torch.serving.frontend",
    "Result": "repro_torch.serving.frontend",
    "ServingFrontend": "repro_torch.serving.frontend",
    "Ticket": "repro_torch.serving.frontend",
    "ReadBatcher": "repro_torch.serving.serve_step",
    "ServeConfig": "repro_torch.serving.serve_step",
    "ServeSession": "repro_torch.serving.serve_step",
    "FlashCrowdSampler": "repro_torch.serving.traffic",
    "MixSampler": "repro_torch.serving.traffic",
    "ScanSampler": "repro_torch.serving.traffic",
    "TenantLoad": "repro_torch.serving.traffic",
    "ZipfianSampler": "repro_torch.serving.traffic",
    "format_report": "repro_torch.serving.traffic",
    "run_closed_loop": "repro_torch.serving.traffic",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)

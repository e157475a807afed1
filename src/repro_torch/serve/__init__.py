"""repro_torch.serve — scheduler-as-a-service: a multi-tenant SimSession
server whose sessions allocate on the card.

An asyncio JSONL-over-TCP server (stdlib only) holding thousands of named
streaming sessions behind credit-based admission and a weighted-DRF fair
queue, with snapshot-backed eviction of idle sessions and write-ahead
journal crash recovery (``kill -9`` mid-run resumes bit-identically).  The
protocol and the store are the JAX package's, so clients and stores cross
between the two.

    from repro_torch import api
    api.serve(store="var/serve", max_live=256)          # blocking server
    c = api.connect(port=PORT, tenant="acme")           # a tenant client
    c.open("s0", "GreedyP */OPT=MIN", nodes=128)
    c.submit("s0", workload="lublin", jobs=100, seed=1)
    c.step_until("s0", 3600.0)
    print(c.result("s0")["max_stretch"])

Names load on first use, so ``repro_torch.serve.client`` imports no torch.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "CreditParams": "admission", "FairQueue": "admission",
    "TenantState": "admission",
    "Client": "client", "ServeError": "client", "connect": "client",
    "ProtocolError": "protocol",
    "SessionRegistry": "registry", "SessionStore": "registry",
    "SchedServer": "server", "ServeConfig": "server",
    "ServerThread": "server", "run_server": "server",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

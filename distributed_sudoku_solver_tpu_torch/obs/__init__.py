"""Observability, copied from the JAX package's ``obs`` (host code, stdlib only).

The modules are the JAX package's with their imports pointed at this
package: the span recorder (``trace``), latency histograms (``hist``), log
correlation (``logctx``), SLO burn monitoring (``slo``), Prometheus
exposition and its lint (``prom``, ``promck``), critical-path attribution
(``critpath``), lock-order tracing and the runtime lockdep witness
(``ordertrace``, ``lockdep``, its hierarchy in ``lock_manifest``), cluster
roll-ups (``agg``) and the tools' exit codes (``exitcodes``).  The JAX
package's ``compilewatch`` (XLA compile accounting) has no counterpart yet.
"""

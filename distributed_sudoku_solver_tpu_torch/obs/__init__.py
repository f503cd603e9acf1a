"""Observability, copied from the JAX package's ``obs`` (host code, stdlib only).

The modules are the JAX package's with their imports pointed at this
package: the span recorder (``trace``), latency histograms (``hist``), log
correlation (``logctx``), SLO burn monitoring (``slo``), Prometheus
exposition and its lint (``prom``, ``promck``), critical-path attribution
(``critpath``), lock-order tracing and the runtime lockdep witness
(``ordertrace``, ``lockdep``, its hierarchy in ``lock_manifest``), cluster
roll-ups (``agg``), the Chrome-trace validator (``traceck``) and the
tools' exit codes (``exitcodes``).  ``compilewatch`` is the JAX watch's
counterpart in torch terms: it watches kernel-library builds and first
loads instead of XLA compilations, and its cost plane prices a serving
round from a static model of the kernels' int32 operations.
"""

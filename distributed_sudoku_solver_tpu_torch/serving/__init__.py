"""The serving stack, from the JAX package's ``serving``.

The engine (``engine``: flights, recovery, ``host_fetch``), the resident
scheduler (``scheduler``), the latency-mode megastep (``megastep``), the
HTTP node (``http``), and the engine-free host layers: fault injection and
recovery policy (``faults``), the brownout controller (``brownout``) and
the durable job journal (``journal``).  Unlike the JAX package's, this
``__init__`` imports nothing, so importing a host module never pulls in an
engine.
"""

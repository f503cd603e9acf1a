"""Serving host layers, copied from the JAX package's ``serving``.

So far the engine-free modules: fault injection and recovery policy
(``faults``), the brownout controller (``brownout``) and the durable job
journal (``journal``).  The engine, the resident scheduler and the HTTP
node come later; unlike the JAX package's, this ``__init__`` imports
nothing, so importing a host module never pulls in an engine.
"""

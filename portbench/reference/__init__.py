"""The plain numpy reference that decides ``correct``.  It imports nothing of
the program, and nothing of JAX."""

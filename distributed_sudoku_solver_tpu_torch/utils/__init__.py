"""Host utilities: the pure-Python oracle, puzzle corpus and stepped advances."""

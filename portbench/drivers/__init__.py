"""One module per traffic kind (``traffic/<mix>.json`` names it under
``"kind"``); each exposes ``run(cell) -> dict``."""

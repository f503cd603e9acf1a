"""Branch-rule names and their config-time validation.

The same spellings as the JAX package's ``ops/ordering.py``: the legacy
rules and the ``head:<name>`` scored heads.  The scored heads are not
ported yet, so a head rule passes the spelling check and is then refused
with ``NotImplementedError`` when a config or problem is built.
"""

from __future__ import annotations

#: The scored heads of the JAX package, in registry order.
HEAD_NAMES = ("minrem", "cw-slack", "mlp")

#: Legacy (non-head) branch rules.
LEGACY_RULES = ("minrem", "first", "mixed", "minrem-desc")

#: Decided/invalid cells take this key: any live key packs strictly smaller.
BIG = 2**30


def is_head_rule(rule: str) -> bool:
    return isinstance(rule, str) and rule.startswith("head:")


def validate_branch(rule: str) -> None:
    """Config-time validation of a branch rule string (legacy or head).

    Raises ``ValueError`` on an unknown rule, as the JAX package does, and
    ``NotImplementedError`` on a known scored head, which this package does
    not run yet."""
    if rule in LEGACY_RULES:
        return
    if is_head_rule(rule):
        name = rule[len("head:"):]
        if name in HEAD_NAMES:
            raise NotImplementedError(
                f"branch head {rule!r}: not ported yet (legacy rules: "
                f"{', '.join(LEGACY_RULES)})"
            )
        raise ValueError(
            f"unknown branch head {name!r} (known: {', '.join(HEAD_NAMES)})"
        )
    raise ValueError(
        f"unknown branch rule {rule!r} (legacy: {', '.join(LEGACY_RULES)}; "
        f"heads: {', '.join('head:' + h for h in HEAD_NAMES)})"
    )

"""The control of `correct`: the program with one guarantee broken.

The configurations state no precision; they state lossless decode. The
control breaks it the way a later change could be tempted to, to save a
round of the match kernel: the store decodes with one resolve round
fewer than its archive's deepest pointer chain needs. Every selection
decode on the fused path runs `max_depth` rounds, so lowering it leaves
the chains of the deepest blocks unresolved (the archive's depth
schedule is tight: some block needs every round it schedules).
"""
from __future__ import annotations


def fewer_rounds(store) -> None:
    """Make `store` decode with one resolve round fewer than it needs."""
    da = store.decoder.da
    if not da.max_depth:
        raise ValueError("the archive records no chain depth")
    da.max_depth = int(da.max_depth) - 1

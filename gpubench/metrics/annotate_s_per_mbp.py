"""Seconds per Mbp of genome in the annotate layer (stage names in
`gpubench/layers.py`), host clock, over the traced run's window."""

from gpubench.layers import per_mbp

UNIT = "s/Mbp"


def read(ctx):
    return per_mbp(ctx, "annotate")

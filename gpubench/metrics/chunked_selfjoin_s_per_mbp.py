"""Seconds per Mbp of genome in the coarse self-join's chunk loop (the
`coarse.chunked_selfjoin` span, open only on genomes padded past
`max_selfjoin_bp`), host clock, over the traced run's window; None where
the self-join ran whole."""

UNIT = "s/Mbp"


def read(ctx):
    secs = ctx["stage_times"].get("coarse.chunked_selfjoin")
    if secs is None or not ctx["mbp"]:
        return None
    return secs / ctx["mbp"]

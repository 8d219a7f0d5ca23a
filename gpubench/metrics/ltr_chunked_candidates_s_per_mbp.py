"""Seconds per Mbp of genome in the LTR candidates' chunk loop (the
`ltr.chunked_candidates` span, open only on genomes padded past the LTR
chunk), host clock, over the traced run's window; None where the LTR
self-join ran whole."""

UNIT = "s/Mbp"


def read(ctx):
    secs = ctx["stage_times"].get("ltr.chunked_candidates")
    if secs is None or not ctx["mbp"]:
        return None
    return secs / ctx["mbp"]

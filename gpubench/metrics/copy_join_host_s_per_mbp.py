"""Seconds per Mbp of genome in the copy join's host chaining: each join's
grouping of its HSPs by (candidate, strand, contig) and the exact chaining
loop (`copies.join_chain`), host clock, over the traced run's window; None
where the span did not run."""

UNIT = "s/Mbp"


def read(ctx):
    secs = ctx["stage_times"].get("copies.join_chain")
    if secs is None or not ctx["mbp"]:
        return None
    return secs / ctx["mbp"]

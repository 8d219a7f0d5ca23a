"""Seconds per Mbp of genome in the copy join's device steps: every
attempt's seed pairing through its counts' read-back (`copies.join_pairs`)
and the HSP scan through its read-back (`copies.join_scan`), host clock,
over the traced run's window.  The read-backs wait for the card, so the
spans hold its time.  None where neither span ran."""

UNIT = "s/Mbp"

SPANS = ("copies.join_pairs", "copies.join_scan")


def read(ctx):
    st = ctx["stage_times"]
    secs = [st[k] for k in SPANS if k in st]
    if not secs or not ctx["mbp"]:
        return None
    return sum(secs) / ctx["mbp"]

"""Seconds per Mbp of genome the boundary engines spend preparing their
family batches on the host (every `*.ba_prep` span: frames, copy rows,
bucketing and packing), host clock, over the traced run's window."""

UNIT = "s/Mbp"


def read(ctx):
    st = ctx["stage_times"]
    spans = [v for k, v in st.items() if k.endswith(".ba_prep")]
    if not spans or not ctx["mbp"]:
        return None
    return sum(spans) / ctx["mbp"]

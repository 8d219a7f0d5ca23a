"""Seconds per Mbp of genome the boundary engines spend in their device
batches (every `*.ba_batch` span: upload, MSA and column statistics,
read-back and the unpacking into analyses), host clock, over the traced
run's window."""

UNIT = "s/Mbp"


def read(ctx):
    st = ctx["stage_times"]
    spans = [v for k, v in st.items() if k.endswith(".ba_batch")]
    if not spans or not ctx["mbp"]:
        return None
    return sum(spans) / ctx["mbp"]

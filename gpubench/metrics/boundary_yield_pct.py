"""The boundary engines' yield: families finished (every
`*.ba_done_items` counter) per hundred items analysed (every
`*.ba_analyze_items` counter), over the traced run's window; None when
nothing was analysed or the program counts no finished family."""

UNIT = "%"


def read(ctx):
    c = ctx["counters"]
    analysed = sum(v for k, v in c.items() if k.endswith(".ba_analyze_items"))
    done = [v for k, v in c.items() if k.endswith(".ba_done_items")]
    if not analysed or not done:
        return None
    return 100.0 * sum(done) / analysed

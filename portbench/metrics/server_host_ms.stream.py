"""Host ms per served wave inside StreamServer's calls (submit: checks,
staging, the copies and the replay launched; the resolving poll; the
close and open of the streams whose window ended), less the wait for the
card, which the benchmark takes apart."""


def read(ctx):
    h = ctx["host_s"]
    if "submit" not in h or not ctx["units"]:
        return None
    return (h["submit"] + h.get("resolve", 0.0) + h.get("reopen", 0.0)) \
        / ctx["units"] * 1e3

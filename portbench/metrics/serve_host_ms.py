"""The serving front end (`serve.ScoringService.score_batch`,
`_dispatch`): ms a call in which the device ran nothing, the calls' wall
time less the device's busy time within them (each call ends with its
scores read back, so all of the stretch's device work lies in calls)."""


def read(t):
    calls = t.spans.get("call")
    if not calls or not t.kernels:
        return None
    return 1e3 * (t.span_s("call") - t.busy_s()) / len(calls)

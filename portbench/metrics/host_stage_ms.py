"""The training driver (`train.stage_chunk`): host ms a step in the
harness's span around each chunk's staging."""


def read(t):
    if not t.spans.get("stage_chunk") or not t.units:
        return None
    return 1e3 * t.span_s("stage_chunk") / t.units

"""Host seconds in ``plan_program`` during set-up: the roofline plan of
the cell's batch (every bucket's, when serving)."""


def read(run):
    spans = run.spans.get("plan", [])
    return sum(spans) if spans else None

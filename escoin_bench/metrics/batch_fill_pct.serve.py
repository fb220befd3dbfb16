"""Images a serving tick carried, as a share of the bucket's batch: the
window's completed requests over (dispatched ticks x bucket batch), from
the server's ``SloReport``."""


def read(run):
    c = run.counts
    if not c.get("ticks"):
        return None
    return 100.0 * c["completed"] / (c["ticks"] * c["bucket_batch"])
